"""Plain torch version of the gather-aggregate kernel (the oracle).

The function the TPU kernel computes (``src/repro/kernels/gather_aggregate``):
features (N, F), nbrs (N, Dmax) int32 with pad −1 → (N, F) in the
features' dtype, ``out[i] = Σ_j features[nbrs[i, j]]`` over valid ids,
summed in f32, divided by max(#valid, 1) for the mean.
"""
from __future__ import annotations

import torch


def gather_aggregate_ref(features: torch.Tensor, nbrs: torch.Tensor, *,
                         mean: bool = False) -> torch.Tensor:
    mask = nbrs >= 0
    rows = features[nbrs.clamp(min=0).long()]                # (N, Dmax, F)
    rows = torch.where(mask[..., None], rows.float(), 0.0)
    out = rows.sum(dim=1)
    if mean:
        out = out / mask.sum(dim=1, keepdim=True).clamp(min=1)
    return out.to(features.dtype)


def gather_aggregate_t_ref(d_out: torch.Tensor, indptr: torch.Tensor,
                           dst: torch.Tensor, deg=None) -> torch.Tensor:
    """Plain version of the transpose kernel: row u of the result sums
    d_out[i] (÷ max(deg[i], 1) when ``deg`` is given) over u's slice of the
    out-neighbour CSR, in f32 in that order, rounded once to d_out's dtype.
    The CPU tests hold it against autograd of `gather_aggregate_ref`."""
    N, F = d_out.shape
    rows = d_out.float()[dst.long()]
    if deg is not None:
        rows = rows / deg.long()[dst.long()].clamp(min=1)[:, None].float()
    owner = torch.repeat_interleave(torch.arange(N, device=d_out.device),
                                    torch.diff(indptr.long()))
    out = torch.zeros((N, F), dtype=torch.float32, device=d_out.device)
    return out.index_add_(0, owner, rows).to(d_out.dtype)
