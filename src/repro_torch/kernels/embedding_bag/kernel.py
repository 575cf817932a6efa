"""Binding of the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``).

Replaces the TPU kernel ``_bag_kernel`` / ``embedding_bag_pallas`` of
``src/repro/kernels/embedding_bag/kernel.py``: a persistent grid of warps,
each serving several bags at once with 16-byte row loads, reduces each
bag's rows in f32.  Rows that 16-byte loads cannot take (D not a multiple
of 16 bytes, or a table view that is not 16-byte aligned) go to the same
source's narrow kernel, one warp a bag; `load_bytes` picks the path before
the launch.  `embedding_bag_bwd_tbh` binds the backward
(``csrc/embedding_bag_bwd.cu``): the tables' gradient as one warp a segment
of ids sorted by (table, row), deterministic.  The libraries are built on
first use (`repro_torch.kernels._build`).
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
INT32_MAX = 2**31 - 1


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


def _bwd_lib():
    lib = load_library("embedding_bag_bwd")
    if lib.embedding_bag_bwd_launch.argtypes is None:
        lib.embedding_bag_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I,
                                                 _I, _I, _I, _P]
        lib.embedding_bag_bwd_launch.restype = _I
    return lib


def embedding_bag_bwd_tbh(d_out: torch.Tensor, plan, T: int, R: int
                          ) -> torch.Tensor:
    """The gradient (T, R, D) of `embedding_bag_tbh` with respect to its
    tables, in d_out's dtype: zero but in the rows the bags name, where it
    is each segment of ``plan`` (an `ops.BagGradPlan`) reduced in f32 in
    its order and rounded once.  d_out (B, T, D) float32 or bfloat16."""
    if d_out.dim() != 3 or d_out.shape[1] != T:
        raise ValueError(f"need d_out (B, {T}, D), got {tuple(d_out.shape)}")
    B, _, D = d_out.shape
    H = plan.H
    align = d_out.element_size() * (2 if D % 2 == 0 else 1)
    _check("d_out", d_out, DTYPES, (B, T, D), align)
    _check("entry", plan.entry, (torch.int32,), plan.entry.shape, 4)
    _check("coef", plan.coef, (torch.float32,), (B * T * H,), 4)
    _check("seg_start", plan.seg_start, (torch.int32,),
           plan.seg_start.shape, 4)
    _check("seg_row", plan.seg_row, (torch.int64,), plan.seg_row.shape, 8)
    n_seg = plan.seg_row.shape[0]
    if max(n_seg, B * T * H) > INT32_MAX:
        raise ValueError(f"segments and entries must fit int32: {n_seg}, "
                         f"{B * T * H}")
    d_tables = torch.zeros((T, R, D), dtype=d_out.dtype, device=d_out.device)
    if n_seg == 0 or D == 0:
        return d_tables
    lib = _bwd_lib()
    dev = d_out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.embedding_bag_bwd_launch(
            d_out.data_ptr(), plan.entry.data_ptr(), plan.coef.data_ptr(),
            plan.seg_start.data_ptr(), plan.seg_row.data_ptr(),
            d_tables.data_ptr(), n_seg, H, D, DTYPES[d_out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag_bwd launch failed: CUDA error "
                           f"{err}")
    embedding_bag_bwd_tbh.launches += 1
    return d_tables


embedding_bag_bwd_tbh.launches = 0
