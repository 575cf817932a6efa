"""LM-family arch wrapper: the shapes, the train and serving steps and
roofline FLOPs.

The four assigned LM shapes (seq_len × global_batch):
  train_4k     4,096 × 256   — train_step: loss + grad + AdamW
  prefill_32k  32,768 × 32   — serve prefill (forward)
  decode_32k   32,768 × 128  — serve_step: ONE new token, 32k KV cache
  long_500k    524,288 × 1   — long-context decode (skipped for pure
                               full-attention archs)

The partition specs are the reference's (`_lm_pspec`, and
``REPRO_WKV_MODE`` with its default ``col``), in the port's layout
(``configs.base.model_pspecs``).  The train step is the reference's:
`lm_loss` (f32 logits, ``logsumexp − gold``, plus ``aux_weight · aux``),
its gradients and `adamw_update` with the arch's `AdamWConfig`, on a
model built with ``train=True`` (f32 masters); under a mesh
(``models.sharding.use_rules``) `make_train_step` takes the parameters'
specs (``train.step``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from .base import ShapeCell, TensorSpec, abstract_params, model_pspecs
from ..device import resolve_device
from ..models.transformer import (
    Transformer,
    TransformerConfig,
    lm_loss,
    transformer_apply,
    transformer_decode,
    transformer_init,
    transformer_init_sharded,
)
from ..models.sharding import P, PartitionSpec
from ..train.optimizer import AdamWConfig, AdamWState
from ..train.step import make_train_step


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    "long_500k": ShapeCell("long_500k", "decode", {"seq": 524288, "batch": 1}),
}


def _wkv_mode() -> str:
    """The reference's perf toggle (``REPRO_WKV_MODE``): ``col`` (default)
    shards wk/wv's output columns, splitting head_dim when there are fewer
    KV heads than the model axis; ``replicated`` keeps wk/wv whole."""
    return os.environ.get("REPRO_WKV_MODE", "col")


def _lm_pspec(path, leaf) -> PartitionSpec:
    """The reference's rule, on a reference path and leaf shape."""
    rank = len(leaf.shape)
    names = [p for p in path]
    if "embed" in names:
        base = ("model", None)        # (vocab, d_model)
    elif any(n in ("moe",) for n in names):
        nm = names[-1] if names[-1] != "kernel" else names[-2]
        if nm in ("wi", "wg", "wo"):
            base = ("model", None, None)   # (experts, ·, ·) — EP
        else:                               # router
            base = (None, None)
    else:
        nm = names[-2] if names[-1] == "kernel" else names[-1]
        if nm in ("wk", "wv") and _wkv_mode() == "replicated":
            base = (None, None)
        elif nm in ("wq", "wk", "wv", "wi", "wg"):
            base = (None, "model")
        elif nm == "wo":
            base = ("model", None)
        else:                               # norms etc.
            base = (None,) * min(rank, 1)
    pad = rank - len(base)
    return P(*((None,) * pad), *base)


@torch.inference_mode()
def prefill_step(model, tokens):
    """Serve prefill: the full forward, last-position logits only."""
    logits, _ = transformer_apply(model, tokens)
    return logits[:, -1]


@torch.inference_mode()
def decode_step(model, cache, tokens, positions):
    """One new token per sequence against the KV cache."""
    return transformer_decode(model, cache, tokens, positions)


def model_flops(cfg: TransformerConfig, kind: str, batch: int, seq: int
                ) -> float:
    """Analytic MODEL_FLOPS of one step (``repro.configs.lm``'s formula):
    2·N per token for the weights plus the attention products over the mean
    causal context."""
    N = cfg.active_param_count()
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
    B, S = batch, seq
    if cfg.local_global:
        ctx = 0.5 * (min(S, cfg.window) + S)
    elif cfg.window is not None:
        ctx = min(S, cfg.window)
    else:
        ctx = S
    if kind == "train":
        return 6.0 * N * B * S + 6.0 * L * H * hd * ctx * B * S
    if kind == "prefill":
        return 2.0 * N * B * S + 2.0 * L * H * hd * ctx * B * S
    # decode: one token, full-cache attention reads
    return 2.0 * N * B + 4.0 * L * H * hd * ctx * B


@dataclasses.dataclass
class LMArch:
    arch_name: str
    cfg: TransformerConfig
    reduced_cfg: TransformerConfig
    sub_quadratic: bool = False  # window / local-global archs run long_500k
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    family: str = "lm"

    @property
    def name(self) -> str:
        return self.arch_name

    def config(self, reduced: bool = False) -> TransformerConfig:
        return self.reduced_cfg if reduced else self.cfg

    def init(self, generator: torch.Generator, *, reduced: bool = False,
             device="cuda", train: bool = False, plan=None) -> Transformer:
        """The model on ``device`` (raises for CUDA without a card); f32
        trainable masters with ``train``; with ``plan``
        (``train.step.MeshPlan``) a training model of this rank's shards,
        from the same draws."""
        if plan is not None:
            return transformer_init_sharded(
                self.config(reduced), generator, plan.params, plan.mesh,
                device=resolve_device(device))
        return transformer_init(self.config(reduced), generator,
                                device=resolve_device(device), train=train)

    def shapes(self) -> Dict[str, ShapeCell]:
        return dict(LM_SHAPES)

    def skip_reason(self, shape: str) -> Optional[str]:
        if shape == "long_500k" and not self.sub_quadratic:
            return ("pure full-attention stack: no sub-quadratic path for "
                    "524k context (documented skip)")
        return None

    # ---- partition specs (the reference's, in the port's layout) -----------
    def abstract_params(self, shape: str = None, *, reduced: bool = False
                        ) -> Dict[str, TensorSpec]:
        """{parameter name: shape and dtype}, from a model on the meta
        device."""
        return abstract_params(Transformer(self.config(reduced), device="meta"))

    def param_pspecs(self, shape: str = None, *, reduced: bool = False
                     ) -> Dict[str, PartitionSpec]:
        return model_pspecs(Transformer(self.config(reduced), device="meta"),
                            _lm_pspec)

    def opt_pspecs(self, shape: str = None, *, reduced: bool = False
                   ) -> AdamWState:
        ps = self.param_pspecs(shape, reduced=reduced)
        return AdamWState(step=P(), mu=ps, nu=ps)

    def input_pspecs(self, shape: str):
        """train / prefill: tokens (and targets) over the batch axes;
        decode: each layer's cache (B, L, KV, hd) over batch when B > 1 and
        over the sequence (``kv_seq``) on the model axis (on data and model
        for B = 1), tokens and positions over batch."""
        kind = LM_SHAPES[shape].kind
        batch_axes = ("pod", "data")
        B, S = self.batch_seq(shape)
        if kind == "train":
            return {"tokens": P(batch_axes), "targets": P(batch_axes)}
        if kind == "prefill":
            return {"tokens": P(batch_axes)}
        seq_axes = ("model",) if B > 1 else ("data", "model")
        leaf = P(batch_axes if B > 1 else None,
                 seq_axes if len(seq_axes) > 1 else seq_axes[0])
        return {"cache": [{"k": leaf, "v": leaf}
                          for _ in range(self.cfg.n_layers)],
                "tokens": P(batch_axes if B > 1 else None),
                "positions": P(batch_axes if B > 1 else None)}

    def batch_seq(self, shape: str) -> Tuple[int, int]:
        meta = LM_SHAPES[shape].meta
        return meta["batch"], meta["seq"]

    def step_fn(self, shape: str, *, opt: Optional[AdamWConfig] = None,
                plan=None) -> Callable:
        """prefill / decode: the serving steps; train:
        ``step(model, opt_state, tokens, targets) → (loss, model,
        opt_state)`` with ``opt`` (default the arch's `AdamWConfig`),
        sharded by ``plan`` (``train.step.MeshPlan``) when given."""
        kind = LM_SHAPES[shape].kind
        if kind == "prefill":
            return prefill_step
        if kind == "decode":
            return decode_step
        return make_train_step(lm_loss, self.opt if opt is None else opt,
                               plan)

    def model_flops(self, shape: str) -> float:
        B, S = self.batch_seq(shape)
        return model_flops(self.cfg, LM_SHAPES[shape].kind, B, S)
