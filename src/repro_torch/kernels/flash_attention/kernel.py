"""Binding of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``_attn_kernel`` / ``flash_attention_bhsd`` of
``src/repro/kernels/flash_attention/kernel.py``.  Each dtype has one kernel,
chosen by dtype inside the library, with no path from one to the other:

* bfloat16 runs on the tensor cores: one CTA per (query head row, 128
  query rows), two warpgroups of 64 rows, S = Q·Kᵀ and O += P·V by
  ``wgmma`` (P from registers, rounded to bf16; V read MN-major), K / V
  tiles double-buffered in swizzled shared memory by TMA, an f32
  online softmax on the accumulator fragment;
* float32 runs on the CUDA cores (scalar f32 FMAs, 64 query rows a CTA),
  which keeps the f32 reference's 1e-5.

The source explains both designs.  With ``return_lse`` the forward also
returns each row's log-sum-exp, f32 (BH, S), which the backward
(`flash_attention_bwd_bhsd`, ``csrc/flash_attention_bwd.cu``) rebuilds P
from: bf16 at hd 64 / 128 in one ``wgmma`` kernel fed by TMA, with dQ
summed across key tiles in a fixed order (``schedule.py``); bf16 at hd
16 / 32 on ``mma.sync``; f32 on the CUDA cores.  The libraries are built
on first use (`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .._build import load_library
from .schedule import bwd_path, bwd_workspace

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = load_library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                               _I, _I, _I, _I, _I, _F, _F, _P]
        lib.flash_attention_launch.restype = _I
    return lib


def _bwd_lib():
    lib = load_library("flash_attention_bwd")
    if lib.flash_attention_bwd_launch.argtypes is None:
        lib.flash_attention_bwd_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _I, _I, _I, _I, _F, _F, _P]
        lib.flash_attention_bwd_launch.restype = _I
    return lib


def _check_qkv(q, k, v, window, softcap, extra=()):
    BH, S, hd = q.shape
    BKV = k.shape[0]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {hd}")
    if BKV == 0 or BH % BKV:
        raise ValueError(f"q rows {BH} must be a multiple of k/v rows {BKV}")
    for name, t, shape in (("q", q, (BH, S, hd)), ("k", k, (BKV, S, hd)),
                           ("v", v, (BKV, S, hd))):
        if (t.device.type != "cuda" or t.dtype not in DTYPES
                or t.dtype != q.dtype or not t.is_contiguous()
                or tuple(t.shape) != shape or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: need a contiguous, 16-byte aligned float32 or "
                f"bfloat16 CUDA tensor of q's dtype and shape {shape}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    for name, t, shape, dtype in extra:
        if (t.device != q.device or t.dtype != dtype
                or not t.is_contiguous() or tuple(t.shape) != shape
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: need a contiguous, 16-byte aligned {dtype} tensor "
                f"of shape {shape} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    return BH, BKV, S, hd


def _mask_args(causal, window, softcap):
    return (int(causal), -1 if window is None else int(window),
            int(softcap is not None),
            0.0 if softcap is None else float(softcap))


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         return_lse: bool = False):
    """q: (BH, S, hd); k/v: (BKV, S, hd); head row i reads KV row i // G.

    Contiguous CUDA tensors of one dtype (float32 or bfloat16), 16-byte
    aligned, hd in ``HEAD_DIMS``.  Returns o (BH, S, hd) in q's dtype, and
    with ``return_lse`` (o, lse): lse (BH, S) f32, each row's log-sum-exp
    of its scaled (softcapped) scores.
    """
    BH, BKV, S, hd = _check_qkv(q, k, v, window, softcap)
    out = torch.empty_like(q)
    lse = (torch.empty((BH, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if S == 0 or BH == 0:
        return (out, lse) if return_lse else out
    lib = _lib()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, BKV, S, hd,
            DTYPES[q.dtype], *_mask_args(causal, window, softcap),
            1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_bhsd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_bhsd.launches = 0


def flash_attention_bwd_bhsd(q, k, v, o, dout, lse, *, causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients (dq, dk, dv) of `flash_attention_bhsd` at (q, k, v),
    given its output ``o``, the output's gradient ``dout`` (both q's shape
    and dtype) and its ``lse``.  dk / dv sum over each KV row's G query
    rows.  Deterministic: the same inputs give the same bytes.  The
    kernels follow ``schedule.bwd_path`` (dtype, hd); the scratch each
    needs is allocated here (``schedule.bwd_workspace``)."""
    BH, BKV, S, hd = _check_qkv(
        q, k, v, window, softcap,
        extra=(("o", o, tuple(q.shape), q.dtype),
               ("dout", dout, tuple(q.shape), q.dtype),
               ("lse", lse, (q.shape[0], q.shape[1]), torch.float32)))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if S == 0 or BH == 0:
        return dq, dk, dv
    work = bwd_workspace(BH, S, hd, bwd_path(q.dtype == torch.bfloat16, hd))
    dvec = torch.empty(work["dvec"], dtype=torch.float32, device=q.device)
    dq_acc = (torch.empty(work["dq_acc"], dtype=torch.float32,
                          device=q.device) if "dq_acc" in work else None)
    sync = (torch.empty(work["sync"], dtype=torch.int32, device=q.device)
            if "sync" in work else None)
    lib = _bwd_lib()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(),
            None if sync is None else sync.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), BH, BKV, S, hd, DTYPES[q.dtype],
            *_mask_args(causal, window, softcap), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd_bhsd.launches += 1
    return dq, dk, dv


flash_attention_bwd_bhsd.launches = 0
