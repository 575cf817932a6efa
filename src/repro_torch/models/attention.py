"""Grouped-query attention — ``repro.models.attention`` on PyTorch.

Covers the reference's variants: GQA / MQA, qk-norm (RMS over head_dim),
attention-logit softcap, sliding-window masks with local/global
alternation, RoPE positions, bf16 projections and an f32 softmax.

Full-sequence path (`mha_train`, the serving prefill) and decode path
(`mha_decode`, one step against a preallocated KV cache).  Which
attention the full-sequence path runs follows the device, never a config
field: CUDA tensors always go through the hand-written flash-attention
kernel (``repro_torch.kernels.flash_attention``); CPU tensors keep the
reference's ``impl`` meaning, ``"dense"`` or ``"chunked"``, both plain
torch.  So `AttentionConfig` has no ``use_flash`` field.  Sharding
(``_tp_attention``, ``constrain``) has no counterpart on one card and is
left out (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import attention_mask
from .common import Dense, RMSNorm, apply_rope, rotary_embedding, softcap

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_base: float = 10000.0
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    window: Optional[int] = None        # sliding-window size (None = full)


class Attention(nn.Module):
    """wq, wk, wv, wo (and q_norm / k_norm with qk-norm)."""

    def __init__(self, cfg: AttentionConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = Dense(d, h * hd, device=device)
        self.wk = Dense(d, kv * hd, device=device)
        self.wv = Dense(d, kv * hd, device=device)
        self.wo = Dense(h * hd, d, device=device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device=device)
            self.k_norm = RMSNorm(hd, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset_parameters(generator)   # wo: 1/sqrt(h·hd), its fan-in


def attention_init(cfg: AttentionConfig, generator: torch.Generator, *,
                   device=None) -> Attention:
    attn = Attention(cfg, device=device)
    attn.reset_parameters(generator)
    return attn


def _project_qkv(attn: Attention, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, S, D) → q (B,S,H,hd), k/v (B,S,KV,hd), with RoPE + qk-norm."""
    cfg = attn.cfg
    B, S, _ = x.shape
    q = attn.wq(x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = attn.wk(x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = attn.wv(x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = attn.q_norm(q)
        k = attn.k_norm(k)
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_base)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_dense(q, k, v, cfg: AttentionConfig) -> torch.Tensor:
    """The reference's dense path: bf16 scores cast to f32, f32 softmax,
    probabilities cast to v's dtype for the product."""
    B, S = q.shape[:2]
    groups = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, S, cfg.n_kv_heads, groups, cfg.head_dim)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores * (1.0 / math.sqrt(cfg.head_dim))
    scores = softcap(scores, cfg.logit_softcap)
    mask = attention_mask(S, causal=True, window=cfg.window, device=q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, cfg.n_heads, cfg.head_dim)


def _attn_chunked(q, k, v, cfg: AttentionConfig, q_chunk: int, kv_chunk: int
                  ) -> torch.Tensor:
    """Blockwise (flash-style) attention in plain torch — only the KV axis
    is chunked, with a running max / sum / accumulator, as the reference's
    ``lax.scan``.  ``q_chunk`` is accepted for API compatibility (unused).
    """
    del q_chunk
    B, S, KV, hd = k.shape
    H = q.shape[2]
    groups = H // KV
    scale = 1.0 / math.sqrt(hd)
    nk = -(-S // kv_chunk)
    qg = q.reshape(B, S, KV, groups, hd)
    kr = k.reshape(B, nk, kv_chunk, KV, hd)
    vr = v.reshape(B, nk, kv_chunk, KV, hd)
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, KV, groups, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, groups, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, groups, S, hd), dtype=torch.float32,
                      device=q.device)
    for ki in range(nk):
        kb, vb = kr[:, ki], vr[:, ki]
        k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, kb).float()
        s = s * scale
        s = softcap(s, cfg.logit_softcap)
        mask = k_pos[None, :] <= q_pos[:, None]
        if cfg.window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < cfg.window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqt,btkh->bkgqh", p.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.einsum("bkgqh->bqkgh", out).reshape(B, S, H, hd)
    return out.to(q.dtype)


def mha_train(attn: Attention, x: torch.Tensor, positions: torch.Tensor, *,
              impl: str = "dense", q_chunk: int = 512, kv_chunk: int = 1024,
              cache: Optional[Cache] = None) -> torch.Tensor:
    """Full-sequence causal attention. x: (B, S, D).

    On CUDA the flash-attention kernel runs whatever ``impl`` says; on the
    CPU ``impl`` picks the reference's dense or chunked path.  With
    ``cache`` (a serving prefill) K and V of positions 0..S−1 are also
    written into it, as S decode steps would leave them."""
    cfg = attn.cfg
    B, S, D = x.shape
    q, k, v = _project_qkv(attn, x, positions)
    if cache is not None:
        _fill_cache(cache, k, v, windowed=cfg.window is not None)
    if x.device.type == "cuda":
        out = flash_ops.flash_attention(q, k, v, causal=True,
                                        window=cfg.window,
                                        softcap=cfg.logit_softcap)
    elif impl == "chunked" and S > q_chunk:
        out = _attn_chunked(q, k, v, cfg, min(q_chunk, S), min(kv_chunk, S))
    else:
        out = _attn_dense(q, k, v, cfg)
    return attn.wo(out.reshape(B, S, -1))


# ---------------------------------------------------------------------------
# Decode path — one new token against a preallocated KV cache.
# ---------------------------------------------------------------------------

def init_cache(cfg: AttentionConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """KV cache for one layer. Sliding-window layers allocate only the
    window (rolling buffer)."""
    length = min(max_seq, cfg.window) if cfg.window is not None else max_seq
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _fill_cache(cache: Cache, k: torch.Tensor, v: torch.Tensor, *,
                windowed: bool) -> None:
    """Write k / v (B, S, KV, hd) of positions 0..S−1 into ``cache``: slot
    t for position t, or t mod L in a windowed layer's rolling buffer of L
    slots, where only the last L positions survive."""
    S, L = k.shape[1], cache["k"].shape[1]
    if not windowed and S > L:
        raise ValueError(f"a cache of {L} positions cannot take {S}")
    pos = torch.arange(max(0, S - L), S, device=k.device)
    slots = pos % L
    cache["k"][:, slots] = k[:, pos].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, pos].to(cache["v"].dtype)


def mha_decode(attn: Attention, cache: Cache, x: torch.Tensor,
               position: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, D); position: (B,) absolute positions. Returns (out, cache).

    K and V are written into ``cache``'s tensors in place (the reference
    returns updated copies; the values are the same).  The attention over
    the whole cache is plain torch, as the reference computes it outside
    any kernel."""
    cfg = attn.cfg
    B = x.shape[0]
    q = attn.wq(x).reshape(B, cfg.n_heads, cfg.head_dim)
    k = attn.wk(x).reshape(B, cfg.n_kv_heads, cfg.head_dim)
    v = attn.wv(x).reshape(B, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = attn.q_norm(q)
        k = attn.k_norm(k)
    cos, sin = rotary_embedding(position, cfg.head_dim, cfg.rope_base)
    q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
    k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]

    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    pos = position.long()
    # rolling-buffer slot for windowed layers, append slot otherwise
    slot = pos % L if cfg.window is not None else pos
    rows = torch.arange(B, device=x.device)
    ck[rows, slot] = k.to(ck.dtype)
    cv[rows, slot] = v.to(cv.dtype)

    groups = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, cfg.n_kv_heads, groups, cfg.head_dim)
    scores = torch.einsum("bkgh,btkh->bkgt", qg.to(ck.dtype), ck).float()
    scores = scores * (1.0 / math.sqrt(cfg.head_dim))
    scores = softcap(scores, cfg.logit_softcap)
    # valid cache entries: t ≤ position (append) / all written slots (rolling)
    t = torch.arange(L, device=x.device)[None, :]
    if cfg.window is not None:
        valid = t < torch.clamp(pos + 1, max=L)[:, None]
    else:
        valid = t <= pos[:, None]
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, cv).reshape(B, 1, -1)
    return attn.wo(out), cache
