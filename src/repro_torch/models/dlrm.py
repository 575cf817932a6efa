"""DLRM-RM2 (Naumov et al., arXiv:1906.00091), the dot-interaction recsys
model (``repro.models.dlrm`` on PyTorch).

13 dense features → bottom MLP; 26 sparse features → EmbeddingBags;
pairwise dot interaction over the 27 embedding-dim vectors; top MLP → CTR
logit.  `retrieval_score` serves the 1 × 10⁶-candidate retrieval cell as
one batched product.

The 26 tables live in one (T, R, D) stack, and all 26 lookups of a
forward are one launch of the embedding-bag kernel.  A serving model
(`dlrm_init` without ``train``: `for_serving`) stores the stack in bf16,
rounded once from the f32 draws (every reference lookup casts its f32 table to bf16 first, so the
values are the same); a training model keeps the reference's f32 tables,
casts them to bf16 at each forward as the reference does (3.3 GB written
a step at full width), and the bag's backward kernel returns their bf16
gradient, which the cast's backward widens to f32.  The interaction, the
MLPs and the top-k are plain products (cuBLAS on the card), as the
reference leaves them to XLA.  `dlrm_apply` and `dlrm_loss` run under
autograd; the serving steps enter ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .common import for_serving
from .embedding import embedding_bag_apply
from .gnn.common import MLP, mlp_apply
from .sharding import constrain

__all__ = ["DLRMConfig", "DLRM", "dlrm_init", "dlrm_apply", "dlrm_loss",
           "retrieval_score"]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    table_rows: int = 1_000_000
    n_hot: int = 1

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_in(self) -> int:
        return self.n_interact + self.embed_dim


class DLRM(nn.Module):
    serve_dtype = {"tables": torch.bfloat16}

    def __init__(self, cfg: DLRMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.bot = MLP((cfg.n_dense,) + cfg.bot_mlp, device=device)
        self.top = MLP((cfg.top_in,) + cfg.top_mlp, device=device)
        self.tables = nn.Parameter(
            torch.empty(cfg.n_sparse, cfg.table_rows, cfg.embed_dim,
                        dtype=torch.float32, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         scale: float = 0.01) -> None:
        self.bot.reset_parameters(generator)
        for t in range(self.cfg.n_sparse):      # f32 draws, one table at a time
            draw = torch.randn(self.tables.shape[1:], generator=generator,
                               device=self.tables.device, dtype=torch.float32)
            self.tables[t].copy_(draw.mul_(scale))
        self.top.reset_parameters(generator)


def dlrm_init(cfg: DLRMConfig, generator: torch.Generator, *,
              device=None, train: bool = False) -> DLRM:
    """Random weights from ``generator``: f32 trainable masters with
    ``train``, else `for_serving`."""
    model = DLRM(cfg, device=device)
    model.reset_parameters(generator)
    return model if train else for_serving(model)


def _interact(vecs: torch.Tensor) -> torch.Tensor:
    """(B, F, D) → (B, F(F−1)/2) upper-triangle pairwise dots."""
    F = vecs.shape[1]
    z = torch.bmm(vecs, vecs.transpose(1, 2))
    iu, ju = np.triu_indices(F, k=1)
    flat = torch.as_tensor(iu * F + ju, device=vecs.device)
    return z.reshape(z.shape[0], F * F)[:, flat]


def _lookups(model: DLRM, sparse_idx: torch.Tensor) -> torch.Tensor:
    """(B, 26, n_hot) ids → (B, 26, D) bf16 bag sums, one kernel launch
    (the f32 tables of a training model are cast to bf16 first)."""
    return embedding_bag_apply(model.tables, sparse_idx)


def dlrm_apply(model: DLRM, dense: torch.Tensor,
               sparse_idx: torch.Tensor) -> torch.Tensor:
    """dense: (B, 13) float; sparse_idx: (B, 26, n_hot) int32 → (B,) bf16
    logits."""
    dense = constrain(dense.to(torch.bfloat16), "batch", None)
    bot = mlp_apply(model.bot, dense, act=torch.relu,
                    final_act=True)                         # (B, D)
    vecs = torch.cat([bot[:, None], _lookups(model, sparse_idx)], dim=1)
    vecs = constrain(vecs, "batch", None, "feature")
    feat = torch.cat([_interact(vecs), bot], dim=-1)
    logit = mlp_apply(model.top, feat, act=torch.relu)
    return logit[:, 0]


def dlrm_loss(model: DLRM, dense: torch.Tensor, sparse_idx: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits."""
    logits = dlrm_apply(model, dense, sparse_idx).float()
    labels = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


@torch.no_grad()
def retrieval_score(model: DLRM, dense: torch.Tensor,
                    sparse_idx: torch.Tensor, candidates: torch.Tensor, *,
                    top_k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score the queries against (C, D) candidate embeddings with one
    batched product; returns (scores, ids) of the top_k, f32 scores,
    best first."""
    bot = mlp_apply(model.bot, dense.to(torch.bfloat16), act=torch.relu,
                    final_act=True)                         # (B, D)
    embs = _lookups(model, sparse_idx)                      # (B, 26, D)
    total = embs[:, 0]
    for t in range(1, embs.shape[1]):   # the reference's sum(), in order
        total = total + embs[:, t]
    query = bot + total                                     # fused user tower
    scores = (query @ candidates.to(query.dtype).T).float()
    # bf16-valued scores tie often; a stable sort takes the lower id first
    # among equals, as lax.top_k does, where torch.topk's order is unstated
    top, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[:, :top_k], ids[:, :top_k]
