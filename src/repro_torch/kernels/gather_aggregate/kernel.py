"""Binding of the gather-aggregate CUDA kernel (``csrc/gather_aggregate.cu``).

Replaces the TPU kernel ``_agg_kernel`` / ``gather_aggregate_pallas`` of
``src/repro/kernels/gather_aggregate/kernel.py``: one warp per node sums
its valid neighbours' feature rows in f32, in neighbour order.  The library
is built on first use (`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT32_MAX = 2**31 - 1


def _lib():
    lib = load_library("gather_aggregate")
    if lib.gather_aggregate_launch.argtypes is None:
        lib.gather_aggregate_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I,
                                                _I, _P]
        lib.gather_aggregate_launch.restype = _I
    return lib


def gather_aggregate_nf(features: torch.Tensor, nbrs: torch.Tensor, *,
                        mean: bool = False) -> torch.Tensor:
    """features (N, F) float32 or bfloat16; nbrs (N, Dmax) int32, pad −1 →
    (N, F) in the features' dtype.  Contiguous tensors on one CUDA device."""
    if features.dim() != 2 or nbrs.dim() != 2 or \
            nbrs.shape[0] != features.shape[0]:
        raise ValueError(f"need features (N, F) and nbrs (N, Dmax), got "
                         f"{tuple(features.shape)} and {tuple(nbrs.shape)}")
    N, F = features.shape
    Dmax = nbrs.shape[1]
    if max(N, F, Dmax) > INT32_MAX:
        raise ValueError(f"N, F and Dmax must fit int32: {N}, {F}, {Dmax}")
    align = features.element_size() * (2 if F % 2 == 0 else 1)
    for name, t, dtypes, a in (("features", features, DTYPES, align),
                               ("nbrs", nbrs, (torch.int32,), 4)):
        if (t.device.type != "cuda" or t.dtype not in dtypes
                or not t.is_contiguous() or t.data_ptr() % a):
            raise ValueError(
                f"{name}: need a contiguous CUDA tensor of dtype "
                f"{list(dtypes)}, {a}-byte aligned; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if nbrs.device != features.device:
        raise ValueError(f"nbrs on {nbrs.device}, features on {features.device}")
    out = torch.empty_like(features)
    if out.numel() == 0:
        return out
    lib = _lib()
    dev = features.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_aggregate_launch(
            features.data_ptr(), nbrs.data_ptr(), out.data_ptr(), N, F, Dmax,
            DTYPES[features.dtype], int(mean), stream)
    if err != 0:
        raise RuntimeError(f"gather_aggregate launch failed: CUDA error {err}")
    gather_aggregate_nf.launches += 1
    return out


gather_aggregate_nf.launches = 0
