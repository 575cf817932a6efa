"""Binding of the gather-aggregate CUDA kernel (``csrc/gather_aggregate.cu``).

Replaces the TPU kernel ``_agg_kernel`` / ``gather_aggregate_pallas`` of
``src/repro/kernels/gather_aggregate/kernel.py``: node i's valid
neighbours' feature rows summed in f32, in neighbour order, over a padded
table (`gather_aggregate_nf`) or CSR segments (`gather_aggregate_csr_nf`)
— the one kernel, two entry points, a launch count each (one a call).
Rows of up to `LONG_ROW` ids take one warp, longer ones a whole block; a
CSR call (and a padded one with Dmax > `LONG_ROW`) is a memset of the
long rows' queue, which the wrapper allocates with ``torch.empty``, and
one kernel; a padded call with Dmax ≤ `LONG_ROW` is one kernel.  No call
synchronises with the host.
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
_LL = ctypes.c_longlong
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT32_MAX = 2**31 - 1
# rows of more ids than this take the long path: the source's kLongT (a
# card test holds the two equal)
LONG_ROW = 2048


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the library's C functions."""
    lib.gather_aggregate_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                            _I, _P, _P]
    lib.gather_aggregate_launch.restype = _I
    lib.gather_aggregate_csr_launch.argtypes = [_P, _P, _P, _P, _I, _I, _LL,
                                                _I, _I, _I, _P, _P]
    lib.gather_aggregate_csr_launch.restype = _I
    lib.gather_aggregate_work_ints.argtypes = [_I, _LL, _I, _I]
    lib.gather_aggregate_work_ints.restype = _LL
    lib.gather_aggregate_long_threshold.argtypes = []
    lib.gather_aggregate_long_threshold.restype = _I
    return lib


def _lib():
    lib = load_library("gather_aggregate")
    if lib.gather_aggregate_launch.argtypes is None:
        bind(lib)
    return lib


def vec_bytes(F: int, element_size: int, *data_ptrs: int) -> int:
    """The bytes a lane moves a load for rows of F elements at these
    addresses: the largest of 16, 8, 4 and 2 (not below the element) that
    divides the row's bytes and every address.  Every width sums the same
    f32 terms in the same order, so all give the same bytes."""
    for vb in (16, 8, 4, 2):
        if vb >= element_size and (F * element_size) % vb == 0 and all(
                p % vb == 0 for p in data_ptrs):
            return vb
    raise ValueError(f"rows of {F} × {element_size} B at {data_ptrs} are "
                     f"not element-aligned")


def _check_features(features: torch.Tensor) -> None:
    """The kernel's features: (N, F) float32 / bfloat16, contiguous on a
    CUDA device."""
    if (features.device.type != "cuda" or features.dtype not in DTYPES
            or not features.is_contiguous()
            or features.data_ptr() % features.element_size()):
        raise ValueError(
            f"features: need a contiguous CUDA tensor of dtype "
            f"{list(DTYPES)}; got {features.dtype} "
            f"{tuple(features.shape)} on {features.device}")


def _launch(name: str, features: torch.Tensor, launch) -> torch.Tensor:
    """Allocate the output (and the long rows' queue), call ``launch(lib,
    out, vec, work)`` on the current stream, raise if it fails."""
    out = torch.empty_like(features)
    if out.numel() == 0:
        return out
    lib = _lib()
    dev = features.device
    vec = vec_bytes(features.shape[1], features.element_size(),
                    features.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(lib, out, vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def _work(lib, N: int, nnz: int, Dmax: int, csr: bool, device):
    """The long rows' queue a call needs (int32 scratch), or None."""
    n = lib.gather_aggregate_work_ints(N, nnz, Dmax, int(csr))
    return torch.empty(n, dtype=torch.int32, device=device) if n else None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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

    def launch(lib, out, vec, stream):
        work = _work(lib, N, 0, Dmax, False, features.device)
        return lib.gather_aggregate_launch(
            features.data_ptr(), nbrs.data_ptr(), out.data_ptr(), N, F, Dmax,
            DTYPES[features.dtype], int(mean), vec, _ptr(work), stream)

    out = _launch("gather_aggregate", features, launch)
    if out.numel():
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
    nnz = src.numel()
    if max(N + 1, F, nnz) > INT32_MAX:
        raise ValueError(f"N + 1, F and nnz must fit int32: {N + 1}, {F}, "
                         f"{nnz}")
    _check_features(features)
    for name, t, shape in (("indptr", indptr, (N + 1,)),
                           ("src", src, (nnz,))):
        if (t.device != features.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(
                f"{name}: need a contiguous int32 tensor of shape {shape} on "
                f"{features.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")

    def launch(lib, out, vec, stream):
        work = _work(lib, N, nnz, 0, True, features.device)
        return lib.gather_aggregate_csr_launch(
            features.data_ptr(), indptr.data_ptr(), src.data_ptr(),
            out.data_ptr(), N, F, nnz, DTYPES[features.dtype], int(mean), vec,
            _ptr(work), stream)

    out = _launch("gather_aggregate_csr", features, launch)
    if out.numel():
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
