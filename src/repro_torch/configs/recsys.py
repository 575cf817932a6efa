"""RecSys-family arch wrapper (``repro.configs.recsys``): DLRM's shapes,
inputs, train and serving steps and roofline FLOPs.

  train_batch     batch=65,536  (training: loss + grad + AdamW)
  serve_p99       batch=512     (online inference forward)
  serve_bulk      batch=262,144 (offline scoring forward)
  retrieval_cand  batch=1 × 1,000,000 candidates (batched-dot retrieval)

The train step is the reference's: `dlrm_loss`, its gradients and
`adamw_update` with the arch's `AdamWConfig` (lr 1e-3), on a model built
with ``train=True`` (f32 tables and MLPs; the tables get a dense update
every step, as in the reference).  The serving steps run under
``torch.inference_mode()``.  Partition specs wait for the sharding item.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..data.synthetic import dlrm_batches
from ..device import resolve_device
from ..models.dlrm import (DLRM, DLRMConfig, dlrm_apply, dlrm_init, dlrm_loss,
                           retrieval_score)
from ..train.optimizer import AdamWConfig
from ..train.step import make_train_step
from .base import ShapeCell, TensorSpec

RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", dict(batch=65_536)),
    "serve_p99": ShapeCell("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeCell("serve_bulk", "serve", dict(batch=262_144)),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}
_REDUCED_BATCH = {"train_batch": 32, "serve_p99": 8, "serve_bulk": 64,
                  "retrieval_cand": 1}


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference computes it on bf16:
    ``1/(1 + e^−x)`` with each step rounded (``torch.sigmoid`` rounds once,
    which moved a third of bf16 probabilities by one unit)."""
    return 1 / (1 + torch.exp(-x))


@torch.inference_mode()
def serve_step(model: DLRM, dense, sparse_idx) -> torch.Tensor:
    """Click probabilities: sigmoid of the logits."""
    return sigmoid(dlrm_apply(model, dense, sparse_idx))


@torch.inference_mode()
def retr_step(model: DLRM, dense, sparse_idx, candidates):
    return retrieval_score(model, dense, sparse_idx, candidates, top_k=100)


@dataclasses.dataclass
class RecsysArch:
    arch_name: str
    cfg: DLRMConfig
    reduced_cfg: DLRMConfig
    opt: AdamWConfig = dataclasses.field(
        default_factory=lambda: AdamWConfig(lr=1e-3))
    family: str = "recsys"

    @property
    def name(self) -> str:
        return self.arch_name

    def shapes(self) -> Dict[str, ShapeCell]:
        return dict(RECSYS_SHAPES)

    def config(self, reduced: bool = False) -> DLRMConfig:
        return self.reduced_cfg if reduced else self.cfg

    def init(self, generator: torch.Generator, *, reduced: bool = False,
             device="cuda", train: bool = False) -> DLRM:
        """The model on ``device`` (raises for CUDA without a card); f32
        trainable tables and MLPs with ``train``."""
        return dlrm_init(self.config(reduced), generator,
                         device=resolve_device(device), train=train)

    # ---- inputs ------------------------------------------------------------
    def batch(self, shape: str, reduced: bool = False) -> int:
        if reduced:
            return _REDUCED_BATCH[shape]
        return RECSYS_SHAPES[shape].meta["batch"]

    def n_candidates(self, shape: str, reduced: bool = False) -> int:
        C = 10_000 if reduced else RECSYS_SHAPES[shape].meta["n_candidates"]
        return -(-C // 512) * 512  # the reference pads to mesh-divisible

    def input_specs(self, shape: str, *, reduced: bool = False
                    ) -> Dict[str, TensorSpec]:
        cfg = self.config(reduced)
        B = self.batch(shape, reduced)
        specs = {
            "dense": TensorSpec((B, cfg.n_dense), torch.float32),
            "sparse_idx": TensorSpec((B, cfg.n_sparse, cfg.n_hot),
                                     torch.int32),
        }
        kind = RECSYS_SHAPES[shape].kind
        if kind == "train":
            specs["labels"] = TensorSpec((B,), torch.int32)
        if kind == "retrieval":
            specs["candidates"] = TensorSpec(
                (self.n_candidates(shape, reduced), cfg.embed_dim),
                torch.float32)
        return specs

    def inputs(self, shape: str, *, reduced: bool = False, seed: int = 0,
               step: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
        """One step's inputs on ``device``: `dlrm_batches` at ``step`` (the
        reference's draws), candidates as f32 normals from ``(seed, step,
        1)``."""
        device = resolve_device(device)
        cfg = self.config(reduced)
        specs = self.input_specs(shape, reduced=reduced)
        batch = next(dlrm_batches(cfg, self.batch(shape, reduced), seed=seed,
                                  start_step=step))
        out = {k: torch.as_tensor(batch[k]).to(device) for k in specs
               if k in batch}
        if "candidates" in specs:
            rng = np.random.default_rng((seed, step, 1))
            cand = rng.standard_normal(specs["candidates"].shape,
                                       dtype=np.float32)
            out["candidates"] = torch.as_tensor(cand).to(device)
        return out

    # ---- steps ---------------------------------------------------------------
    def step_fn(self, shape: str) -> Callable:
        """serve / retrieval: the serving steps; train_batch:
        ``step(model, opt_state, dense, sparse_idx, labels) → (loss, model,
        opt_state)``."""
        kind = RECSYS_SHAPES[shape].kind
        if kind == "serve":
            return serve_step
        if kind == "retrieval":
            return retr_step
        return make_train_step(dlrm_loss, self.opt)

    # ---- roofline --------------------------------------------------------------
    def model_flops(self, shape: str) -> float:
        cfg = self.cfg
        B = self.batch(shape)
        kind = RECSYS_SHAPES[shape].kind
        dims_bot = (cfg.n_dense,) + cfg.bot_mlp
        dims_top = (cfg.top_in,) + cfg.top_mlp
        mlp = sum(2 * a * b for a, b in zip(dims_bot, dims_bot[1:]))
        mlp += sum(2 * a * b for a, b in zip(dims_top, dims_top[1:]))
        f = cfg.n_sparse + 1
        interact = 2 * f * f * cfg.embed_dim
        lookup = 2 * cfg.n_sparse * cfg.n_hot * cfg.embed_dim
        fwd = B * (mlp + interact + lookup)
        if kind == "train":
            return 3.0 * fwd
        if kind == "retrieval":
            C = RECSYS_SHAPES[shape].meta["n_candidates"]
            return fwd + 2.0 * B * C * cfg.embed_dim
        return float(fwd)


CONFIG = DLRMConfig(
    n_dense=13, n_sparse=26, embed_dim=64,
    bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
    table_rows=1_000_000, n_hot=1,
)

REDUCED = DLRMConfig(
    n_dense=13, n_sparse=26, embed_dim=16,
    bot_mlp=(32, 16), top_mlp=(64, 32, 1),
    table_rows=1000, n_hot=1,
)
