"""Public wrapper: the GQA layout glue around the flash-attention kernel.

``models/attention.mha_train`` sends every CUDA tensor here.  A CUDA tensor
launches the kernel (``kernel.py``); a CPU tensor takes the plain version
(``ref.py``); any other device raises.  There is no fallback from the
kernel to the plain version.  Any S is taken (the reference asserts
``S % bq == 0``; the kernel masks the ragged tail itself).
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_bhsd
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd), q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, S, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
    out = flash_attention_bhsd(qf, kf, vf, causal=causal, window=window,
                               softcap=softcap)
    return out.reshape(B, H, S, hd).transpose(1, 2)
