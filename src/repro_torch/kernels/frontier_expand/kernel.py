"""Binding of the frontier-expansion CUDA kernel (``csrc/frontier_expand.cu``).

Replaces the TPU kernel ``_frontier_kernel`` / ``frontier_expand`` of
``src/repro/kernels/frontier_expand/kernel.py``.  The source explains the
three-pass design (count, exclusive scan, write) that keeps the reference's
survivor order without relying on in-order grid steps.  The library is
built on first use (`repro_torch.kernels._build`).

``chunk`` must be at most 64: a row's chunk is one 64-bit survivor mask.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_CHUNK = 64


def _lib():
    lib = load_library("frontier_expand")
    if lib.frontier_expand_launch.argtypes is None:
        lib.frontier_expand_launch.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
            _I, _I, _P, _P, _P, _P, _P, _P]
        lib.frontier_expand_launch.restype = _I
        lib.frontier_expand_scratch.argtypes = [_I, _I, _I]
        lib.frontier_expand_scratch.restype = ctypes.c_longlong
    return lib


def _check(name, t, dtype, shape=None):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def frontier_expand(labels, out_indptr, out_indices, in_indptr, in_indices,
                    emb, count, plan_rows, *, level: int, chunk: int,
                    max_chunks: int, bisect_iters: int):
    """Launch one expansion level for a bucket of P patterns.

    labels (n,), out/in_indptr (n+1,), out/in_indices (E,) int32 (edgeless
    graphs pass 1-element sentinels); emb (P, cap, k) int32 with columns
    ≥ level equal to -1; count (P,) int32; plan_rows (P, 5 + 2k) int32 rows
    [anchor_pos, anchor_out, cand_label, min_out, min_in, check_out[k],
    check_in[k]] of this level.  Returns (out_emb (P, cap, k) int32,
    out_count (P,) int32, found (P,) int32, overflowed (P,) bool).
    """
    P, cap, k = emb.shape
    n = labels.shape[0]
    for name, t in (("labels", labels), ("out_indptr", out_indptr),
                    ("out_indices", out_indices), ("in_indptr", in_indptr),
                    ("in_indices", in_indices), ("emb", emb)):
        _check(name, t, torch.int32)
    _check("count", count, torch.int32, (P,))
    _check("plan_rows", plan_rows, torch.int32, (P, 5 + 2 * k))
    if not 0 < level < k:
        raise ValueError(f"level must be in [1, k), got {level} (k={k})")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    dev = emb.device
    out_emb = torch.full((P, cap, k), -1, dtype=torch.int32, device=dev)
    out_count = torch.empty(P, dtype=torch.int32, device=dev)
    found = torch.empty(P, dtype=torch.int32, device=dev)
    ovf = torch.empty(P, dtype=torch.bool, device=dev)
    lib = _lib()
    tile_sums = torch.empty(lib.frontier_expand_scratch(P, cap, max_chunks),
                            dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.frontier_expand_launch(
            labels.data_ptr(), out_indptr.data_ptr(),
            out_indices.data_ptr(), in_indptr.data_ptr(),
            in_indices.data_ptr(), n, out_indices.shape[0],
            in_indices.shape[0], emb.data_ptr(), count.data_ptr(),
            plan_rows.data_ptr(), P, cap, k, level, chunk, max_chunks,
            bisect_iters, tile_sums.data_ptr(), out_emb.data_ptr(),
            out_count.data_ptr(), found.data_ptr(), ovf.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"frontier_expand launch failed: CUDA error {err}")
    frontier_expand.launches += 1
    return out_emb, out_count, found, ovf


frontier_expand.launches = 0
