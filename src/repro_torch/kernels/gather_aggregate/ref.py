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
