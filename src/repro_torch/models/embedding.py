"""EmbeddingBag, the RecSys lookup (``repro.models.embedding`` on PyTorch).

The reference gathers with ``jnp.take`` and names its Pallas kernel as the
single-shard fast path; here every lookup goes through the embedding-bag
kernel's wrapper (`kernels.embedding_bag.ops`): the kernel for a table on
the card, its plain version for one on the CPU, and under autograd the
kernel's backward.  A table may be stored in the compute dtype already (a
serving DLRM keeps one bf16 stack made once from the f32 draws), which
gives the reference's per-call ``astype`` result without the per-call
cast; a training model's f32 tables are cast at each call, as the
reference casts them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.embedding_bag.ops import embedding_bag
from .common import normal_
from .sharding import extent

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
    kernel launch for all T.  combiner ∈ {sum, mean}.

    The reference constrains the table to ("table_rows", "feature"): rows
    over the model axis.  A row-sharded lookup is not ported (DLRM trains
    and serves without a mesh), so a mesh that splits the rows raises."""
    if extent("table_rows") > 1:
        raise NotImplementedError("a row-sharded embedding-bag lookup is "
                                  "not ported; run DLRM without a mesh")
    return embedding_bag(table.to(dtype), idx, weights, combiner=combiner)
