"""EmbeddingBag, the RecSys lookup (``repro.models.embedding`` on PyTorch).

The reference gathers with ``jnp.take`` and names its Pallas kernel as the
single-shard fast path; here every lookup goes through the embedding-bag
kernel's wrapper (`kernels.embedding_bag.ops`): the kernel for a table on
the card, its plain version for one on the CPU.  A table may be stored in
the compute dtype already (DLRM keeps one bf16 stack made once from the
f32 draws), which gives the reference's per-call ``astype`` result without
the per-call cast.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.embedding_bag.ops import embedding_bag
from .common import normal_

__all__ = ["embedding_bag_init", "embedding_bag_apply"]


def embedding_bag_init(n_rows: int, dim: int, generator: torch.Generator, *,
                       scale: float = 0.01, device=None) -> torch.Tensor:
    """An (n_rows, dim) f32 table drawn as ``scale · N(0, 1)``."""
    table = torch.empty((n_rows, dim), dtype=torch.float32, device=device)
    return normal_(table, scale, generator)


def embedding_bag_apply(table: torch.Tensor, idx: torch.Tensor,
                        weights: Optional[torch.Tensor] = None, *,
                        combiner: str = "sum",
                        dtype=torch.bfloat16) -> torch.Tensor:
    """idx (B, H) int32 bags (pad −1) of an (R, D) table → (B, D) in
    ``dtype``; or idx (B, T, H) of a (T, R, D) stack → (B, T, D), one
    kernel launch for all T.  combiner ∈ {sum, mean}."""
    return embedding_bag(table.to(dtype), idx, weights, combiner=combiner)
