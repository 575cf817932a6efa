"""Public wrappers: the gather-aggregate over CSR segments or a padded
table, and the index layouts it reads.

``models/gnn/graphsage`` sends every aggregation through
`gather_aggregate_csr` over the batch's in-neighbour CSR (`in_csr`: one
stable sort of the valid edges by destination, sources kept in edge
order); `gather_aggregate` over a padded table (pad −1) is the reference
kernel's interface.  A CUDA tensor launches the kernel (``kernel.py``:
rows of up to `kernel.LONG_ROW` ids a warp each, longer rows a block per
column range, scheduled on the card without a host sync); a CPU tensor
takes the plain version (``ref.py``), which autograd differentiates; any
other device raises.  Both add a row's terms in neighbour order in f32,
so they give the same bytes.  There is no fallback from the kernel to the
plain version.

Under autograd (grad mode on and the features requiring a gradient) a
CUDA call goes through `GatherAggregateCSR` / `GatherAggregate`, whose
backward is the transpose kernel over the out-neighbour CSR: the
transpose of the in-CSR by a stable sort of its sources (`csr_transpose`;
a padded table is read as its valid entries first, `out_neighbor_csr`),
so each node's destinations come in a fixed order and the kernel gathers
over them deterministically, with no atomics.

Two ways to a padded table: `pad_adjacency` (the reference's, CSR → a
degree-capped numpy table) and `in_neighbor_table` (torch, on the edges'
device, from a masked edge list; never truncates, so Dmax is the largest
in-degree: on a power-law graph that table dwarfs the CSR).
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import (gather_aggregate_csr_nf, gather_aggregate_nf,
                     gather_aggregate_t_nf)
from .ref import gather_aggregate_csr_ref, gather_aggregate_ref


def _counts_to_indptr(counts: torch.Tensor) -> torch.Tensor:
    indptr = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                         device=counts.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr.to(torch.int32)


def csr_transpose(indptr: torch.Tensor, src: torch.Tensor):
    """The transpose of the CSR whose row i lists ``src[indptr[i]:indptr[i
    + 1]]`` (int32, ids in [0, N)), on its device: (indptr (N + 1,), dst
    (nnz,), deg (N,)), all int32.  Node u's slice of ``dst`` lists the rows
    i with u among their ids, in ascending (i, position) order (a stable
    sort by u); deg[i] is row i's length."""
    N = indptr.numel() - 1
    deg = torch.diff(indptr)
    rows = torch.repeat_interleave(
        torch.arange(N, dtype=torch.int32, device=src.device), deg.long())
    order = torch.sort(src, stable=True).indices
    counts = torch.bincount(src.long(), minlength=N)
    return _counts_to_indptr(counts), rows[order], deg.to(torch.int32)


def padded_to_csr(nbrs: torch.Tensor):
    """The CSR (indptr, src) int32 of a padded table nbrs (N, Dmax): each
    row's valid ids (those in [0, N)) in j order."""
    N = nbrs.shape[0]
    valid = (nbrs >= 0) & (nbrs < N)
    return (_counts_to_indptr(valid.sum(dim=1)),
            nbrs[valid].to(torch.int32))


def out_neighbor_csr(nbrs: torch.Tensor):
    """The transpose of the padded in-neighbour table nbrs (N, Dmax), on its
    device: `csr_transpose` of `padded_to_csr`; deg[i] counts row i's
    valid ids."""
    return csr_transpose(*padded_to_csr(nbrs))


def _transpose(d_out, indptr, src, mean):
    """The features' gradient of an aggregate over the CSR (indptr, src):
    the transpose kernel over `csr_transpose`."""
    t_indptr, dst, deg = csr_transpose(indptr, src)
    return gather_aggregate_t_nf(d_out.contiguous(), t_indptr, dst,
                                 deg if mean else None)


class GatherAggregate(torch.autograd.Function):
    """The gather-aggregate kernel over a padded table on CUDA features,
    with the transpose kernel as its backward."""

    @staticmethod
    def forward(ctx, features, nbrs, mean):
        out = gather_aggregate_nf(features, nbrs, mean=mean)
        ctx.save_for_backward(nbrs)
        ctx.mean = mean
        return out

    @staticmethod
    def backward(ctx, d_out):
        (nbrs,) = ctx.saved_tensors
        return _transpose(d_out, *padded_to_csr(nbrs), ctx.mean), None, None


class GatherAggregateCSR(torch.autograd.Function):
    """The gather-aggregate kernel over CSR segments on CUDA features, with
    the transpose kernel as its backward."""

    @staticmethod
    def forward(ctx, features, indptr, src, mean):
        out = gather_aggregate_csr_nf(features, indptr, src, mean=mean)
        ctx.save_for_backward(indptr, src)
        ctx.mean = mean
        return out

    @staticmethod
    def backward(ctx, d_out):
        indptr, src = ctx.saved_tensors
        return _transpose(d_out, indptr, src, ctx.mean), None, None, None


def _kernel_device(features: torch.Tensor) -> bool:
    """True for CUDA features (the kernel), False for CPU ones (the plain
    version); raises for any other device."""
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_aggregate: no kernel for {features.device}")
    return features.device.type == "cuda"


def gather_aggregate(features: torch.Tensor, nbrs: torch.Tensor, *,
                     mean: bool = False) -> torch.Tensor:
    """features (N, F); nbrs (N, Dmax) int32, pad −1 → (N, F)."""
    if not _kernel_device(features):
        return gather_aggregate_ref(features, nbrs, mean=mean)
    features = features.contiguous()
    nbrs = nbrs.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and features.requires_grad:
        return GatherAggregate.apply(features, nbrs, mean)
    return gather_aggregate_nf(features, nbrs, mean=mean)


def gather_aggregate_csr(features: torch.Tensor, indptr: torch.Tensor,
                         src: torch.Tensor, *,
                         mean: bool = False) -> torch.Tensor:
    """features (N, F); node i's neighbours ``src[indptr[i]:indptr[i +
    1]]`` (int32) → (N, F), equal to `gather_aggregate` on the padded
    table of the same rows."""
    if not _kernel_device(features):
        return gather_aggregate_csr_ref(features, indptr, src, mean=mean)
    features = features.contiguous()
    if torch.is_grad_enabled() and features.requires_grad:
        return GatherAggregateCSR.apply(features, indptr, src, mean)
    return gather_aggregate_csr_nf(features, indptr, src, mean=mean)


def in_csr(edge_src: torch.Tensor, edge_dst: torch.Tensor,
           edge_mask: torch.Tensor, n_nodes: int):
    """The in-neighbour CSR of a masked edge list, on the edges' device:
    (indptr (n_nodes + 1,), src (nnz,)) int32, row v the sources of the
    valid edges into v in edge order (one stable sort by destination),
    never truncated."""
    src = edge_src[edge_mask]
    dst = edge_dst[edge_mask]
    order = torch.sort(dst, stable=True).indices
    counts = torch.bincount(dst.long(), minlength=n_nodes)
    return _counts_to_indptr(counts), src[order].to(torch.int32)


def pad_adjacency(indptr: np.ndarray, indices: np.ndarray, d_max: int
                  ) -> np.ndarray:
    """CSR → (N, d_max) padded neighbor table (pad = -1, degree-capped)."""
    n = indptr.shape[0] - 1
    out = np.full((n, d_max), -1, np.int32)
    for v in range(n):
        row = indices[indptr[v]:indptr[v + 1]][:d_max]
        out[v, : row.shape[0]] = row
    return out


def in_neighbor_table(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(n_nodes, Dmax) int32 table: row v holds the sources of the valid
    edges into v in edge order (`in_csr`'s rows), pad −1.  Dmax is the
    largest in-degree (at least 1), so no row is cut short."""
    indptr, src = in_csr(edge_src, edge_dst, edge_mask, n_nodes)
    deg = torch.diff(indptr.long())
    d_max = max(int(deg.max()) if deg.numel() else 0, 1)
    rows = torch.repeat_interleave(torch.arange(n_nodes, device=src.device),
                                   deg)
    pos = torch.arange(src.numel(), device=src.device) - indptr[:-1].long()[
        rows]
    table = torch.full((n_nodes, d_max), -1, dtype=torch.int32,
                       device=src.device)
    table[rows, pos] = src
    return table
