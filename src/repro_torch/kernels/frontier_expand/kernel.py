"""Binding of the frontier-expansion CUDA kernel (``csrc/frontier_expand.cu``).

Replaces the TPU kernel ``_frontier_kernel`` / ``frontier_expand`` of
``src/repro/kernels/frontier_expand/kernel.py``.  The source explains the
design: work split by candidates (one thread a candidate, its row found by
binary search over scanned row offsets), each predicate evaluated once into
a 64-bit survivor mask per (row, chunk), and the reference's (chunk, row,
lane) order rebuilt from the masks' popcounts.  A launch is two halves: the
plan sums the rows' candidate and chunk counts by warp tile of 32 rows and
writes five totals, which the wrapper reads on the host (the one
device-to-host read of a launch) to size the run's scratch by what the
frontier holds: the run's per-row arrays cover the valid tiles only, and
the plan's own scratch is 32 bytes a tile of the (P, cap) table.  The
library is built on first use (`repro_torch.kernels._build`).

``chunk`` must be at most 64: a row's chunk is one 64-bit survivor mask.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
MAX_CHUNK = 64
_GRAPH = [_P, _P, _P, _P, _P, _I, _I, _I]   # CSR pointers, n, n_out, n_in


def _lib():
    lib = load_library("frontier_expand")
    if lib.frontier_expand_plan.argtypes is None:
        lib.frontier_expand_plan.argtypes = _GRAPH + [
            _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
        lib.frontier_expand_plan.restype = _I
        lib.frontier_expand_run.argtypes = _GRAPH + [
            _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _L, _L, _L, _L, _I,
            _P, _P, _P, _P, _P, _P]
        lib.frontier_expand_run.restype = _I
        lib.frontier_expand_plan_bytes.argtypes = [_I, _I]
        lib.frontier_expand_plan_bytes.restype = _L
        lib.frontier_expand_run_bytes.argtypes = [_I, _L, _L, _L, _I]
        lib.frontier_expand_run_bytes.restype = _L
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
    graph = [labels.data_ptr(), out_indptr.data_ptr(), out_indices.data_ptr(),
             in_indptr.data_ptr(), in_indices.data_ptr(), n,
             out_indices.shape[0], in_indices.shape[0]]
    frontier = [emb.data_ptr(), count.data_ptr(), plan_rows.data_ptr(), P,
                cap, k, level, chunk]
    plan = torch.empty(lib.frontier_expand_plan_bytes(P, cap),
                       dtype=torch.uint8, device=dev)
    totals = torch.empty(5, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.frontier_expand_plan(*graph, *frontier, max_chunks,
                                       plan.data_ptr(), totals.data_ptr(),
                                       stream)
        if err != 0:
            raise RuntimeError(f"frontier_expand plan launch failed: CUDA "
                               f"error {err}")
        tiles, cands, slots, tile_chunks, maxc = totals.tolist()
        run = torch.empty(lib.frontier_expand_run_bytes(P, tiles, slots,
                                                        tile_chunks, maxc),
                          dtype=torch.uint8, device=dev)
        err = lib.frontier_expand_run(
            *graph, *frontier, max_chunks, bisect_iters, plan.data_ptr(),
            tiles, cands, slots, tile_chunks, maxc, run.data_ptr(),
            out_emb.data_ptr(), out_count.data_ptr(), found.data_ptr(),
            ovf.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"frontier_expand launch failed: CUDA error {err}")
    frontier_expand.launches += 1
    return out_emb, out_count, found, ovf


frontier_expand.launches = 0
