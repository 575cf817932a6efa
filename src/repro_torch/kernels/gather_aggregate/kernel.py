"""Binding of the gather-aggregate CUDA kernel (``csrc/gather_aggregate.cu``).

Replaces the TPU kernel ``_agg_kernel`` / ``gather_aggregate_pallas`` of
``src/repro/kernels/gather_aggregate/kernel.py``: one warp per node sums
its valid neighbours' feature rows in f32, in neighbour order, over a
padded table (`gather_aggregate_nf`) or CSR segments
(`gather_aggregate_csr_nf`) — the one kernel, two entry points, a launch
count each.
`gather_aggregate_t_nf` binds its transpose (``csrc/gather_aggregate_t.cu``):
the features' gradient as a gather over the out-neighbour table,
deterministic, with 16-byte lanes where the rows allow (`aggt_mode`).  The
libraries are built on first use (`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
        lib.gather_aggregate_csr_launch.argtypes = [_P, _P, _P, _P, _I, _I,
                                                    _I, _I, _P]
        lib.gather_aggregate_csr_launch.restype = _I
    return lib


def _check_features(features: torch.Tensor) -> None:
    """The kernel's features: (N, F) float32 / bfloat16, contiguous on a
    CUDA device, aligned to a column pair when F is even."""
    N, F = features.shape
    align = features.element_size() * (2 if F % 2 == 0 else 1)
    if (features.device.type != "cuda" or features.dtype not in DTYPES
            or not features.is_contiguous() or features.data_ptr() % align):
        raise ValueError(
            f"features: need a contiguous CUDA tensor of dtype "
            f"{list(DTYPES)}, {align}-byte aligned; got {features.dtype} "
            f"{tuple(features.shape)} on {features.device}")


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
    _check_features(features)
    if (nbrs.device != features.device or nbrs.dtype != torch.int32
            or not nbrs.is_contiguous()):
        raise ValueError(f"nbrs: need a contiguous int32 tensor on "
                         f"{features.device}; got {nbrs.dtype} on "
                         f"{nbrs.device}")
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


def gather_aggregate_csr_nf(features: torch.Tensor, indptr: torch.Tensor,
                            src: torch.Tensor, *,
                            mean: bool = False) -> torch.Tensor:
    """features (N, F) float32 or bfloat16; node i's neighbours
    ``src[indptr[i]:indptr[i + 1]]`` (indptr (N + 1,), src (nnz,), int32,
    ids in [0, N)) → (N, F) in the features' dtype, the sums (means)
    `gather_aggregate_nf` gives on the padded table of the same rows.
    Contiguous tensors on one CUDA device."""
    if features.dim() != 2:
        raise ValueError(f"need features (N, F), got {tuple(features.shape)}")
    N, F = features.shape
    if max(N + 1, F, src.numel()) > INT32_MAX:
        raise ValueError(f"N + 1, F and nnz must fit int32: {N + 1}, {F}, "
                         f"{src.numel()}")
    _check_features(features)
    for name, t, shape in (("indptr", indptr, (N + 1,)),
                           ("src", src, (src.numel(),))):
        if (t.device != features.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(
                f"{name}: need a contiguous int32 tensor of shape {shape} on "
                f"{features.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    out = torch.empty_like(features)
    if out.numel() == 0:
        return out
    lib = _lib()
    dev = features.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_aggregate_csr_launch(
            features.data_ptr(), indptr.data_ptr(), src.data_ptr(),
            out.data_ptr(), N, F, DTYPES[features.dtype], int(mean), stream)
    if err != 0:
        raise RuntimeError(f"gather_aggregate_csr launch failed: CUDA error "
                           f"{err}")
    gather_aggregate_csr_nf.launches += 1
    return out


gather_aggregate_csr_nf.launches = 0


def _t_lib():
    lib = load_library("gather_aggregate_t")
    if lib.gather_aggregate_t_launch.argtypes is None:
        lib.gather_aggregate_t_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                                  _I, _I, _P]
        lib.gather_aggregate_t_launch.restype = _I
    return lib


def aggt_mode(F: int, element_size: int, data_ptr: int) -> int:
    """The transpose kernel's path for rows of F elements at ``data_ptr``:
    16 (the 16-byte kernel: F·size a multiple of 16 and the rows 16-byte
    aligned), else 2 (column pairs: F even and pair-aligned), else 1
    (single columns).  Every path sums the same f32 terms in the same
    order, so all give the same bytes."""
    if (F * element_size) % 16 == 0 and data_ptr % 16 == 0:
        return 16
    if F % 2 == 0 and data_ptr % (2 * element_size) == 0:
        return 2
    return 1


def gather_aggregate_t_nf(d_out: torch.Tensor, indptr: torch.Tensor,
                          dst: torch.Tensor,
                          deg: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The gradient (N, F) of `gather_aggregate_nf` with respect to its
    features, in d_out's dtype: row u sums d_out[i] (÷ deg[i] when ``deg``
    is given: the mean) over the destinations i of u's slice of the
    out-neighbour CSR (``indptr`` (N + 1,), ``dst`` (nnz,), int32), in f32
    in that order, rounded once (on every path: `aggt_mode`).  Contiguous
    tensors on one CUDA device."""
    if d_out.dim() != 2:
        raise ValueError(f"need d_out (N, F), got {tuple(d_out.shape)}")
    N, F = d_out.shape
    if max(N, F, dst.numel()) > INT32_MAX:
        raise ValueError(f"N, F and nnz must fit int32: {N}, {F}, "
                         f"{dst.numel()}")
    checks = [("d_out", d_out, DTYPES, (N, F)),
              ("indptr", indptr, (torch.int32,), (N + 1,)),
              ("dst", dst, (torch.int32,), (dst.numel(),))]
    if deg is not None:
        checks.append(("deg", deg, (torch.int32,), (N,)))
    for name, t, dtypes, shape in checks:
        if (t.device != d_out.device or t.device.type != "cuda"
                or t.dtype not in dtypes or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(
                f"{name}: need a contiguous CUDA tensor of dtype "
                f"{list(dtypes)} and shape {shape} on {d_out.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(d_out)
    if out.numel() == 0:
        return out
    mode = aggt_mode(F, d_out.element_size(), d_out.data_ptr())
    lib = _t_lib()
    dev = d_out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_aggregate_t_launch(
            d_out.data_ptr(), indptr.data_ptr(), dst.data_ptr(),
            None if deg is None else deg.data_ptr(), out.data_ptr(), N, F,
            DTYPES[d_out.dtype], mode, stream)
    if err != 0:
        raise RuntimeError(f"gather_aggregate_t launch failed: CUDA error "
                           f"{err}")
    gather_aggregate_t_nf.launches += 1
    return out


gather_aggregate_t_nf.launches = 0
