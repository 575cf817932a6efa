"""Public wrapper: the embedding bag for one table or a stack of them.

``models/embedding`` sends every lookup here.  A CUDA tensor launches the
kernel (``kernel.py``); a CPU tensor takes the plain version (``ref.py``);
any other device raises.  There is no fallback from the kernel to the
plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import embedding_bag_tbh
from .ref import embedding_bag_ref

COMBINERS = ("sum", "mean")


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  combiner: str = "sum") -> torch.Tensor:
    """tables (R, D) with ids (B, H) → (B, D), as the reference's
    ``ops.embedding_bag``; or tables (T, R, D) with ids (B, T, H) →
    (B, T, D), every table in one launch.  Pad ids are −1; weights have
    the ids' shape; the result has the tables' dtype."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    single = tables.dim() == 2
    if single:
        tables, ids = tables[None], ids[:, None]
        weights = None if weights is None else weights[:, None]
    mean = combiner == "mean"
    if tables.device.type == "cpu":
        out = embedding_bag_ref(tables, ids, weights, mean=mean)
    elif tables.device.type == "cuda":
        if weights is not None:
            weights = weights.to(tables.dtype).contiguous()
        out = embedding_bag_tbh(tables.contiguous(),
                                ids.to(torch.int32).contiguous(), weights,
                                mean=mean)
    else:
        raise ValueError(f"embedding_bag: no kernel for {tables.device}")
    return out[:, 0] if single else out
