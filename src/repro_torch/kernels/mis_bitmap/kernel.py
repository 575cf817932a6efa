"""Binding of the greedy-mIS CUDA kernel (``csrc/mis_bitmap.cu``).

Replaces the TPU kernel ``_mis_kernel`` / ``mis_bitmap_select`` of
``src/repro/kernels/mis_bitmap/kernel.py``: one CTA per pattern of the
bucket scans all rows in order, with the bitmap in shared memory while it
fits the card's opt-in limit and in global memory beyond it.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("mis_bitmap")
    if lib.mis_greedy_launch.argtypes is None:
        lib.mis_greedy_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _P]
        lib.mis_greedy_launch.restype = _I
        lib.mis_smem_limit.argtypes = [_I]
        lib.mis_smem_limit.restype = _I
    return lib


def smem_limit_bytes(device) -> int:
    """Largest bitmap (bytes) the kernel keeps in shared memory on ``device``."""
    return _lib().mis_smem_limit(torch.device(device).index or 0)


def uses_shared_memory(n_words: int, device) -> bool:
    return n_words * 4 <= smem_limit_bytes(device)


def mis_bitmap_select(bitmap, count, emb, n_valid, tau, *, k: int):
    """bitmap (P, Nw) int32 words; count/n_valid/tau (P,) int32; emb
    (P, cap, K≥k) int32.  Returns new (bitmap, count); inputs are untouched.
    """
    P, cap, K = emb.shape
    Nw = bitmap.shape[1]
    for name, t, shape in (("bitmap", bitmap, (P, Nw)), ("count", count, (P,)),
                           ("emb", emb, (P, cap, K)), ("n_valid", n_valid, (P,)),
                           ("tau", tau, (P,))):
        if (t.device.type != "cuda" or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name}: need a contiguous int32 CUDA tensor of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if not 1 <= k <= min(K, 16):
        raise ValueError(f"k must be in [1, min(K, 16)], got k={k}, K={K}")
    dev = emb.device
    use_smem = uses_shared_memory(Nw, dev)
    bm_out = bitmap.clone()
    cnt_out = count.clone()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mis_greedy_launch(bm_out.data_ptr(), cnt_out.data_ptr(),
                                    emb.data_ptr(), n_valid.data_ptr(),
                                    tau.data_ptr(), P, cap, K, k, Nw,
                                    int(use_smem), stream)
    if err != 0:
        raise RuntimeError(f"mis_bitmap launch failed: CUDA error {err}")
    mis_bitmap_select.launches += 1
    return bm_out, cnt_out


mis_bitmap_select.launches = 0
