"""Plain torch version of the flash-attention kernel (the oracle).

The function the TPU kernel computes (``src/repro/kernels/flash_attention``):
dense scores in f32 (q, k and v are cast to f32 first, as the Pallas kernel
does), scaled by ``1/sqrt(hd)``, then the tanh softcap, the causal and
window mask with ``-1e30``, softmax, and the product with V in f32; the
result is cast to q's dtype.  Shapes: q (B, S, H, hd); k/v (B, S, KV, hd)
with H % KV == 0, query head h reading KV head h // (H / KV).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(S: int, *, causal: bool, window: Optional[int],
                   device=None) -> torch.Tensor:
    """(S, S) bool, True = query i attends to key j."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= (i - j) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(S, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
