"""Public wrappers: the gather-aggregate and its padded neighbour tables.

``models/gnn/graphsage`` sends every aggregation here.  A CUDA tensor
launches the kernel (``kernel.py``); a CPU tensor takes the plain version
(``ref.py``), which autograd differentiates; any other device raises.
There is no fallback from the kernel to the plain version.

Under autograd (grad mode on and the features requiring a gradient) a
CUDA call goes through `GatherAggregate`, a ``torch.autograd.Function``
whose backward is the transpose kernel: `out_neighbor_csr` builds the
out-neighbour table of ``nbrs`` on the card with a stable sort (so the
order of each node's destinations is fixed), and the kernel gathers over
it (deterministic, no atomics).

Two ways to the padded table: `pad_adjacency` (the reference's, CSR → a
degree-capped numpy table) and `in_neighbor_table` (torch, on the edges'
device, from a masked edge list; never truncates).
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import gather_aggregate_nf, gather_aggregate_t_nf
from .ref import gather_aggregate_ref


def out_neighbor_csr(nbrs: torch.Tensor):
    """The transpose of the padded in-neighbour table nbrs (N, Dmax), on its
    device: (indptr (N + 1,), dst (nnz,), deg (N,)), all int32.  Node u's
    slice of ``dst`` lists the rows i with nbrs[i, j] = u for some j, in
    ascending (i, j) order (a stable sort by u); deg[i] counts row i's
    valid ids (those in [0, N))."""
    N = nbrs.shape[0]
    dev = nbrs.device
    valid = (nbrs >= 0) & (nbrs < N)
    src = nbrs[valid].long()                        # row-major: (i, j) order
    rows = torch.arange(N, device=dev)[:, None].expand_as(nbrs)[valid]
    order = torch.sort(src, stable=True)[1]
    indptr = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=N), 0)
    return (indptr.to(torch.int32), rows[order].to(torch.int32),
            valid.sum(dim=1).to(torch.int32))


class GatherAggregate(torch.autograd.Function):
    """The gather-aggregate kernel on CUDA features with the transpose
    kernel as its backward."""

    @staticmethod
    def forward(ctx, features, nbrs, mean):
        out = gather_aggregate_nf(features, nbrs, mean=mean)
        ctx.save_for_backward(nbrs)
        ctx.mean = mean
        return out

    @staticmethod
    def backward(ctx, d_out):
        (nbrs,) = ctx.saved_tensors
        indptr, dst, deg = out_neighbor_csr(nbrs)
        d_feat = gather_aggregate_t_nf(d_out.contiguous(), indptr, dst,
                                       deg if ctx.mean else None)
        return d_feat, None, None


def gather_aggregate(features: torch.Tensor, nbrs: torch.Tensor, *,
                     mean: bool = False) -> torch.Tensor:
    """features (N, F); nbrs (N, Dmax) int32, pad −1 → (N, F)."""
    if features.device.type == "cpu":
        return gather_aggregate_ref(features, nbrs, mean=mean)
    if features.device.type != "cuda":
        raise ValueError(f"gather_aggregate: no kernel for {features.device}")
    features = features.contiguous()
    nbrs = nbrs.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and features.requires_grad:
        return GatherAggregate.apply(features, nbrs, mean)
    return gather_aggregate_nf(features, nbrs, mean=mean)


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
    edges into v in edge order (a stable sort by destination), pad −1.
    Dmax is the largest in-degree (at least 1), so no row is cut short."""
    dev = edge_src.device
    src = edge_src[edge_mask].long()
    dst = edge_dst[edge_mask].long()
    dst_sorted, order = torch.sort(dst, stable=True)
    deg = torch.bincount(dst, minlength=n_nodes)
    d_max = max(int(deg.max()) if deg.numel() else 0, 1)
    start = torch.cumsum(deg, 0) - deg
    pos = torch.arange(dst.numel(), device=dev) - start[dst_sorted]
    table = torch.full((n_nodes, d_max), -1, dtype=torch.int32, device=dev)
    table[dst_sorted, pos] = src[order].to(torch.int32)
    return table
