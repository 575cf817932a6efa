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

The source explains both designs.  The library is built on first use
(`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = load_library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                               _I, _I, _I, _I, _F, _F, _P]
        lib.flash_attention_launch.restype = _I
    return lib


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """q: (BH, S, hd); k/v: (BKV, S, hd); head row i reads KV row i // G.

    Contiguous CUDA tensors of one dtype (float32 or bfloat16), 16-byte
    aligned, hd in ``HEAD_DIMS``.  Returns o (BH, S, hd) in q's dtype.
    """
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
    out = torch.empty_like(q)
    if S == 0 or BH == 0:
        return out
    lib = _lib()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, BKV,
            S, hd, DTYPES[q.dtype], int(causal),
            -1 if window is None else int(window), int(softcap is not None),
            0.0 if softcap is None else float(softcap),
            1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
