"""Public wrapper: the GQA layout glue around the flash-attention kernels.

``models/attention.mha_train`` sends every CUDA tensor here.  A CUDA tensor
launches the kernels (``kernel.py``); a CPU tensor takes the plain version
(``ref.py``), which autograd differentiates; any other device raises.
There is no fallback from a kernel to the plain version.  Any S is taken
(the reference asserts ``S % bq == 0``; the kernels mask the ragged tail
themselves).

Under autograd (grad mode on and q, k or v requiring a gradient) a CUDA
call goes through `FlashAttention`, a ``torch.autograd.Function``: the
forward kernel also writes each row's log-sum-exp, and the backward runs
the backward kernels on it.  Otherwise (serving, ``inference_mode``) the
forward kernel alone runs, as before, and stores no log-sum-exp.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_bhsd, flash_attention_bwd_bhsd
from .ref import flash_attention_ref


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(B, S, N, hd) → the kernels' (B·N, S, hd), contiguous."""
    B, S, N, hd = t.shape
    return t.transpose(1, 2).reshape(B * N, S, hd).contiguous()


def _unrows(t: torch.Tensor, B: int) -> torch.Tensor:
    """(B·N, S, hd) → (B, S, N, hd)."""
    BN, S, hd = t.shape
    return t.reshape(B, BN // B, S, hd).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """Flash attention on CUDA tensors with a kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        qf, kf, vf = _rows(q), _rows(k), _rows(v)
        out, lse = flash_attention_bhsd(qf, kf, vf, causal=causal,
                                        window=window, softcap=softcap,
                                        return_lse=True)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.mask = (causal, window, softcap)
        return _unrows(out, q.shape[0])

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        B = dout.shape[0]
        dq, dk, dv = flash_attention_bwd_bhsd(
            qf, kf, vf, out, _rows(dout.to(qf.dtype)), lse, causal=causal,
            window=window, softcap=softcap)
        return _unrows(dq, B), _unrows(dk, B), _unrows(dv, B), None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd), q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    out = flash_attention_bhsd(_rows(q), _rows(k), _rows(v), causal=causal,
                               window=window, softcap=softcap)
    return _unrows(out, q.shape[0])
