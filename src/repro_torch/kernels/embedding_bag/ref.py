"""Plain torch version of the embedding-bag kernel (the oracle).

The function the TPU kernel computes (``src/repro/kernels/embedding_bag``),
with a leading table axis and optional per-id weights: tables (T, R, D),
ids (B, T, H) int32 with pad −1, weights (B, T, H) or None →
(B, T, D) in the tables' dtype.  An id is valid in [0, R): pads (−1) and
ids ≥ R (outside the reference's contract, where it reads out of bounds)
add nothing, as in the kernel.  A weighted row is rounded to the tables'
dtype (the reference model's ``rows * weights.astype(dtype)``), the sum
runs in f32, the mean divides by the number of valid ids (at least 1).
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(tables: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None, *,
                      mean: bool = False) -> torch.Tensor:
    T, R = tables.shape[:2]
    mask = (ids >= 0) & (ids < R)
    t_index = torch.arange(T, device=ids.device)[None, :, None]
    rows = tables[t_index, torch.where(mask, ids, 0).long()]  # (B, T, H, D)
    if weights is not None:
        rows = rows * weights.to(tables.dtype)[..., None]
    rows = torch.where(mask[..., None], rows.float(), 0.0)
    out = rows.sum(dim=2)
    if mean:
        out = out / mask.sum(dim=2, keepdim=True).clamp(min=1)
    return out.to(tables.dtype)


def embedding_bag_grad_from_plan(d_out: torch.Tensor, plan, T: int, R: int
                                 ) -> torch.Tensor:
    """Plain version of the backward kernel's segment reduction: the
    tables' gradient (T, R, D) in d_out's dtype from an `ops.BagGradPlan`,
    each segment summed in f32 in its order and rounded once.  The CPU
    tests hold the plan against autograd of `embedding_bag_ref` with it."""
    B, _, D = d_out.shape
    rows = d_out.reshape(B * T, D).float()[plan.entry.long() // plan.H]
    contrib = rows * plan.coef[plan.entry.long()][:, None]
    seg = torch.repeat_interleave(
        torch.arange(plan.seg_row.numel(), device=d_out.device),
        torch.diff(plan.seg_start.long()))
    sums = torch.zeros((plan.seg_row.numel(), D), dtype=torch.float32,
                       device=d_out.device).index_add_(0, seg, contrib)
    out = torch.zeros((T * R, D), dtype=d_out.dtype, device=d_out.device)
    out[plan.seg_row] = sums.to(d_out.dtype)
    return out.reshape(T, R, D)
