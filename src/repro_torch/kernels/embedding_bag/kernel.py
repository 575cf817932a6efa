"""Binding of the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``).

Replaces the TPU kernel ``_bag_kernel`` / ``embedding_bag_pallas`` of
``src/repro/kernels/embedding_bag/kernel.py``: a persistent grid of warps,
each serving several bags at once with 16-byte row loads, reduces each
bag's rows in f32.  Rows that 16-byte loads cannot take (D not a multiple
of 16 bytes, or a table view that is not 16-byte aligned) go to the same
source's narrow kernel, one warp a bag; `load_bytes` picks the path before
the launch.  The library is built on first use (`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = load_library("embedding_bag")
    if lib.embedding_bag_launch.argtypes is None:
        lib.embedding_bag_launch.argtypes = [_P, _P, _P, _P, _L, _I, _L, _I,
                                             _I, _I, _I, _I, _P]
        lib.embedding_bag_launch.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, dtypes, shape, align: int) -> None:
    if (t.device.type != "cuda" or t.dtype not in dtypes
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape)
            or t.data_ptr() % align):
        raise ValueError(
            f"{name}: need a contiguous CUDA tensor of dtype {list(dtypes)}, "
            f"shape {tuple(shape)}, {align}-byte aligned; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def load_bytes(tables: torch.Tensor, out: torch.Tensor) -> int:
    """Bytes a lane loads at a time: 16 where D·size and both pointers
    allow it, else two elements where they allow that, else one."""
    es = tables.element_size()
    row = tables.shape[-1] * es
    for nbytes in (16, 2 * es):
        if row % nbytes == 0 and tables.data_ptr() % nbytes == 0 \
                and out.data_ptr() % nbytes == 0:
            return nbytes
    return es


def embedding_bag_tbh(tables: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None, *,
                      mean: bool = False) -> torch.Tensor:
    """tables (T, R, D) float32 or bfloat16; ids (B, T, H) int32, pad −1;
    weights (B, T, H) in the tables' dtype or None → (B, T, D), tables'
    dtype.  All on one CUDA device, contiguous."""
    if tables.dim() != 3 or ids.dim() != 3:
        raise ValueError(f"need tables (T, R, D) and ids (B, T, H), got "
                         f"{tuple(tables.shape)} and {tuple(ids.shape)}")
    T, R, D = tables.shape
    B, T2, H = ids.shape
    if T2 != T:
        raise ValueError(f"ids name {T2} tables, the stack holds {T}")
    _check("tables", tables, DTYPES, (T, R, D), tables.element_size())
    _check("ids", ids, (torch.int32,), (B, T, H), 4)
    if weights is not None:
        _check("weights", weights, (tables.dtype,), (B, T, H), 1)
    out = torch.empty((B, T, D), dtype=tables.dtype, device=tables.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    dev = tables.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.embedding_bag_launch(
            tables.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            B * T, T, R, D, H, DTYPES[tables.dtype], int(mean),
            load_bytes(tables, out), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    embedding_bag_tbh.launches += 1
    return out


embedding_bag_tbh.launches = 0
