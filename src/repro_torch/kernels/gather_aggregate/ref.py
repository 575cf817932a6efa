"""Plain torch versions of the gather-aggregate kernel (the oracles).

The function the TPU kernel computes (``src/repro/kernels/gather_aggregate``):
features (N, F) → (N, F) in the features' dtype, ``out[i] = Σ_j
features[ids[j]]`` over node i's valid neighbours, summed in f32 in
neighbour order, divided by max(#valid, 1) for the mean, rounded once.
Two layouts of the neighbours, as the kernel's: a padded table nbrs (N,
Dmax) int32 with pad −1 (`gather_aggregate_ref`), or CSR segments indptr
(N + 1,), src (nnz,) (`gather_aggregate_csr_ref`).  Both add one neighbour
position at a time to an f32 accumulator, the order the kernel and the
reference's Pallas kernel add in, so on the same graph the two layouts give
the same bytes, and the kernel gives them too.
"""
from __future__ import annotations

import torch

# ids of one chunk in `gather_aggregate_csr_ref`: its gathered rows take
# CSR_IDS·F elements of the features' dtype, whatever the graph's size
CSR_IDS = 1 << 22


def gather_aggregate_ref(features: torch.Tensor, nbrs: torch.Tensor, *,
                         mean: bool = False) -> torch.Tensor:
    mask = nbrs >= 0
    acc = torch.zeros(features.shape, dtype=torch.float32,
                      device=features.device)
    for j in range(nbrs.shape[1]):
        rows = features[nbrs[:, j].clamp(min=0).long()]
        acc = acc + torch.where(mask[:, j, None], rows.float(), 0.0)
    if mean:
        acc = acc / mask.sum(dim=1, keepdim=True).clamp(min=1)
    return acc.to(features.dtype)


def gather_aggregate_csr_ref(features: torch.Tensor, indptr: torch.Tensor,
                             src: torch.Tensor, *,
                             mean: bool = False) -> torch.Tensor:
    """`gather_aggregate_ref` over CSR segments: row i sums the feature
    rows ``src[indptr[i]:indptr[i + 1]]`` → (rows, F) with rows =
    ``indptr.numel() − 1`` (N for a graph's CSR; fewer for a range of its
    rows).  Rows are taken in decreasing degree (a stable sort), in chunks
    of whole rows holding up to CSR_IDS ids; a chunk gathers its rows'
    features once, position-major (position j of every row longer than j,
    the rows a prefix of the chunk), and adds position j to those rows'
    partial sums, splitting off the rows that end there.  So a chunk costs
    its longest row's positions, both passes touch each id's row once (no
    step allocates a whole chunk or the features: autograd too), and the
    peak stays a chunk beside the result, whatever the degrees."""
    N, F = indptr.numel() - 1, features.shape[1]
    dev = features.device
    starts = indptr[:-1].long()
    deg = indptr[1:].long() - starts
    order = torch.sort(deg, descending=True, stable=True).indices
    d_sorted = deg[order]
    # chunk boundaries: whole rows, CSR_IDS ids at most (one longer row alone)
    ends = torch.cumsum(d_sorted, 0).cpu()
    bounds, c0 = [], 0
    while c0 < N:
        before = int(ends[c0 - 1]) if c0 else 0
        c1 = max(c0 + 1, int(torch.searchsorted(ends, before + CSR_IDS,
                                                right=True)))
        bounds.append((c0, c1))
        c0 = c1
    vals = []
    for c0, c1 in bounds:
        d, first = d_sorted[c0:c1], starts[order[c0:c1]]
        # longer[j]: how many rows of the chunk have more than j ids
        longer = torch.bincount(d).flip(0).cumsum(0).flip(0)[1:]
        acc = torch.zeros((0, F), dtype=torch.float32, device=dev)
        if longer.numel():
            # position-major ids: position p of the chunk's row r goes to
            # offset[p] + r
            offset = torch.cumsum(longer, 0) - longer
            row = torch.repeat_interleave(torch.arange(c1 - c0, device=dev),
                                          d)
            pos = torch.arange(row.numel(), device=dev) - (
                torch.cumsum(d, 0) - d)[row]
            ids = torch.empty_like(row)
            ids[offset[pos] + row] = src[first[row] + pos].long()
            longer = longer.tolist()
            pieces = torch.split(features[ids], longer)
            acc = torch.zeros((longer[0], F), dtype=torch.float32,
                              device=dev) + pieces[0].float()
            done = []
            for n, piece in zip(longer[1:], pieces[1:]):
                acc, ended = torch.split(acc, [n, acc.shape[0] - n])
                done.append(ended)
                acc = acc + piece.float()
            acc = torch.cat([acc, *reversed(done)])
        acc = torch.cat([acc, acc.new_zeros((c1 - c0 - acc.shape[0], F))])
        if mean:
            acc = acc / d.clamp(min=1)[:, None]
        vals.append(acc.to(features.dtype))
    out = features.new_empty((N, F))
    if N == 0:
        return out
    return out.index_copy(0, order, torch.cat(vals))


def gather_aggregate_t_ref(d_out: torch.Tensor, indptr: torch.Tensor,
                           dst: torch.Tensor, deg=None) -> torch.Tensor:
    """Plain version of the transpose kernel: row u of the result sums
    d_out[i] (÷ max(deg[i], 1) when ``deg`` is given) over u's slice of the
    out-neighbour CSR, in f32 in that order, rounded once to d_out's dtype.
    The CPU tests hold it against autograd of `gather_aggregate_ref`."""
    N, F = d_out.shape
    rows = d_out.float()[dst.long()]
    if deg is not None:
        rows = rows / deg.long()[dst.long()].clamp(min=1)[:, None].float()
    owner = torch.repeat_interleave(torch.arange(N, device=d_out.device),
                                    torch.diff(indptr.long()))
    out = torch.zeros((N, F), dtype=torch.float32, device=d_out.device)
    return out.index_add_(0, owner, rows).to(d_out.dtype)
