"""LM-family arch wrapper: the shapes, the serving steps and roofline FLOPs.

The four assigned LM shapes (seq_len × global_batch):
  train_4k     4,096 × 256   — train_step (not ported: no training step yet)
  prefill_32k  32,768 × 32   — serve prefill (forward)
  decode_32k   32,768 × 128  — serve_step: ONE new token, 32k KV cache
  long_500k    524,288 × 1   — long-context decode (skipped for pure
                               full-attention archs)

Only what serving needs comes over from ``repro.configs.lm``: no partition
specs and no optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from .base import ShapeCell
from ..models.transformer import (
    TransformerConfig,
    transformer_apply,
    transformer_decode,
)


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    "long_500k": ShapeCell("long_500k", "decode", {"seq": 524288, "batch": 1}),
}


def prefill_step(model, tokens):
    """Serve prefill: the full forward, last-position logits only."""
    logits, _ = transformer_apply(model, tokens)
    return logits[:, -1]


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

    @property
    def name(self) -> str:
        return self.arch_name

    def shapes(self) -> Dict[str, ShapeCell]:
        return dict(LM_SHAPES)

    def skip_reason(self, shape: str) -> Optional[str]:
        if shape == "long_500k" and not self.sub_quadratic:
            return ("pure full-attention stack: no sub-quadratic path for "
                    "524k context (documented skip)")
        return None

    def batch_seq(self, shape: str) -> Tuple[int, int]:
        meta = LM_SHAPES[shape].meta
        return meta["batch"], meta["seq"]

    def step_fn(self, shape: str) -> Callable:
        kind = LM_SHAPES[shape].kind
        if kind == "prefill":
            return prefill_step
        if kind == "decode":
            return decode_step
        raise NotImplementedError(
            f"{shape}: the training step is not ported yet (ROADMAP.md)")

    def model_flops(self, shape: str) -> float:
        B, S = self.batch_seq(shape)
        return model_flops(self.cfg, LM_SHAPES[shape].kind, B, S)
