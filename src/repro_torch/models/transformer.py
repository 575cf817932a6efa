"""Decoder-only transformer — ``repro.models.transformer`` on PyTorch.

The reference scans over stacked layer parameters; here the layers are an
``nn.ModuleList`` walked by a Python loop, flat in execution order
(``local, global, local, …`` for alternating stacks, which the reference
scans as pairs).  Dense FFN (``silu(g)·h``) only: ``n_experts > 0`` raises
until ``models/moe.py`` is ported (ROADMAP).

`TransformerConfig` has the reference's fields minus ``use_flash``: which
attention runs follows the device (see ``attention.py``).  ``remat`` and
``scan_layers`` are kept so configurations read the same, and ignored:
the port has no backward pass to rematerialise and always loops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from .attention import (
    Attention,
    AttentionConfig,
    Cache,
    init_cache,
    mha_decode,
    mha_train,
)
from .common import Dense, RMSNorm, embed_apply, normal_, softcap

__all__ = ["TransformerConfig", "Transformer", "transformer_init",
           "transformer_apply", "lm_loss", "init_decode_cache",
           "transformer_decode"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                          # dense-FFN hidden (ignored if MoE)
    # --- MoE (n_experts == 0 → dense; MoE is not ported yet) ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # --- attention variant ---
    window: Optional[int] = None       # sliding window (all layers)
    local_global: bool = False         # alternate local(window)/global layers
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_base: float = 10000.0
    # --- execution ---
    remat: bool = True                 # kept, ignored (no backward pass)
    attn_impl: str = "dense"           # CPU only: "dense" | "chunked"
    q_chunk: int = 512
    kv_chunk: int = 1024
    scan_layers: bool = True           # kept, ignored (always a loop)
    dtype: Any = torch.bfloat16

    def attn_cfg(self, *, local: bool) -> AttentionConfig:
        win = self.window if (local or not self.local_global) else None
        return AttentionConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            rope_base=self.rope_base,
            qk_norm=self.qk_norm,
            logit_softcap=self.attn_softcap,
            window=win,
        )

    @property
    def layers_per_step(self) -> int:
        return 2 if self.local_global else 1

    @property
    def n_scan_steps(self) -> int:
        assert self.n_layers % self.layers_per_step == 0
        return self.n_layers // self.layers_per_step

    def layer_is_local(self, i: int) -> bool:
        """Layer i of the flat stack: the first of each (local, global)
        pair is local."""
        return self.local_global and i % 2 == 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers), for 6·N·D."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads * 2) + d * hd * (self.n_kv_heads * 2)
        if self.n_experts:
            ffn = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.vocab * d + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        inactive = (self.n_layers * (self.n_experts - self.top_k) * 3
                    * self.d_model * self.moe_d_ff)
        return full - inactive


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x · 1/(1 + e^−x)``
    in x's dtype, each step rounded (``F.silu`` rounds once, which moves a
    third of bf16 outputs by one unit in the last place)."""
    return x * (1 / (1 + torch.exp(-x)))


class FFN(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.wi = Dense(cfg.d_model, cfg.d_ff, device=device)
        self.wg = Dense(cfg.d_model, cfg.d_ff, device=device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(silu(self.wg(x)) * self.wi(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, local: bool, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, device=device)
        self.ln_ffn = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg.attn_cfg(local=local), device=device)
        self.ffn = FFN(cfg, device=device)

    def forward(self, x, positions, cfg: TransformerConfig,
                cache: Optional[Cache] = None):
        x = x + mha_train(self.attn, self.ln_attn(x), positions,
                          impl=cfg.attn_impl, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk, cache=cache)
        return x + self.ffn(self.ln_ffn(x))

    def decode(self, x, cache: Cache, position):
        a, cache = mha_decode(self.attn, cache, self.ln_attn(x), position)
        x = x + a
        return x + self.ffn(self.ln_ffn(x)), cache


class Transformer(nn.Module):
    """``embed`` (vocab, d_model) in ``cfg.dtype``, ``layers``, ``ln_final``;
    the output projection is the tied embedding."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (n_experts={cfg.n_experts}) are not "
                "ported yet (models/moe.py; see ROADMAP.md)")
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model,
                                              dtype=cfg.dtype, device=device),
                                  requires_grad=False)
        self.layers = nn.ModuleList(
            Block(cfg, local=cfg.layer_is_local(i), device=device)
            for i in range(cfg.n_layers))
        self.ln_final = RMSNorm(cfg.d_model, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init distributions: embedding N(0, 1), dense
        N(0, 1/fan_in), norm scales 1."""
        normal_(self.embed, 1.0, generator)
        for blk in self.layers:
            blk.attn.reset_parameters(generator)
            for lin in (blk.ffn.wi, blk.ffn.wg, blk.ffn.wo):
                lin.reset_parameters(generator)


def transformer_init(cfg: TransformerConfig, generator: torch.Generator, *,
                     device=None) -> Transformer:
    """Random weights from ``generator`` (on ``device``'s type).  The draws
    differ from ``jax.random``'s; tests carry the reference's weights over
    with ``repro_torch.interop.transformer_params_from_numpy``."""
    model = Transformer(cfg, device=device)
    model.reset_parameters(generator)
    return model


def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = embed_apply(model.embed, tokens, dtype=cfg.dtype)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = model.ln_final(x)
    logits = torch.einsum("bsd,vd->bsv", x, model.embed.to(cfg.dtype))
    return softcap(logits, cfg.final_softcap)


@torch.no_grad()
def transformer_apply(model: Transformer, tokens: torch.Tensor,
                      cache: Optional[List[Cache]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int → (logits (B, S, V) in cfg.dtype, aux_loss).

    With ``cache`` (from `init_decode_cache`, at least S positions) the
    forward also fills it, so decoding can go on at position S: a serving
    prefill.  The reference replays the prompt through decode instead."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = _embed(model, tokens)
    caches = [None] * len(model.layers) if cache is None else cache
    for blk, layer_cache in zip(model.layers, caches):
        x = blk(x, positions, model.cfg, layer_cache)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(model, x), aux


def lm_loss(model: Transformer, tokens: torch.Tensor, targets: torch.Tensor,
            *, aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy of the forward pass (no gradient)."""
    logits, aux = transformer_apply(model, tokens)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (logz - gold).mean() + aux_weight * aux


def init_decode_cache(cfg: TransformerConfig, batch: int, max_seq: int, *,
                      device=None) -> List[Cache]:
    """One ``{"k", "v"}`` cache per layer, in the flat layer order."""
    return [init_cache(cfg.attn_cfg(local=cfg.layer_is_local(i)), batch,
                       max_seq, cfg.dtype, device)
            for i in range(cfg.n_layers)]


@torch.no_grad()
def transformer_decode(model: Transformer, cache: List[Cache],
                       tokens: torch.Tensor, positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[Cache]]:
    """One decode step. tokens: (B, 1); positions: (B,). Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    x = _embed(model, tokens)
    for blk, layer_cache in zip(model.layers, cache):
        x, _ = blk.decode(x, layer_cache, positions)
    return _logits(model, x), cache
