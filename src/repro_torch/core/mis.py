"""mIS — the paper's Maximal-Independent-Set support metric.

Two interchangeable implementations compute the *identical* set — the
lexicographically-first maximal independent set in embedding-row order —
when run to completion (τ = ∞).  Under early exit (τ reached mid-selection)
each returns *some* valid independent set of size τ (the paper's contract,
§3.1.1):

  * ``mis_greedy_update`` — the sequential scan over embedding rows
    carrying a packed used-vertex bitmap; the plain version of the
    ``repro_torch.kernels.mis_bitmap`` kernel, which the batched plane runs
    on the card.
  * ``mis_luby_update`` — parallel rounds: an embedding is accepted in a
    round iff its priority (row index) is the minimum over every data vertex
    it touches (one ``scatter_reduce(..., "amin")`` per round).

Bitmaps are int32 words, ``(P, ⌈n/32⌉)`` with a leading pattern axis: torch
on the CPU has no uint32 shift, ``index_add_`` or ``index_put_``, so the
words are stored signed and only *viewed* as uint32 (bit-identical) where
they are compared with the reference (`repro_torch.interop`).  Every update
here takes the leading pattern axis P of the batched plane.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "bitmap_words",
    "bitmap_init",
    "mis_greedy_update",
    "mis_luby_update",
    "touches_used",
]

# bit b of a word as an int32 value (bit 31 is the sign bit)
_BITS = np.array([1 << b for b in range(32)], np.uint32).view(np.int32)


def bitmap_words(n: int) -> int:
    return (n + 31) // 32


def bitmap_init(n: int, device="cpu") -> torch.Tensor:
    """Packed used-vertex bitmap for a data graph of n vertices (int32 words)."""
    return torch.zeros(bitmap_words(n), dtype=torch.int32, device=device)


def _bits(verts: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_BITS, device=verts.device)[(verts & 31).long()]


def touches_used(bitmap: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """For (rows, k) vertex ids: does any vertex have its bit set?"""
    words = (verts >> 5).long()
    return ((bitmap[words] & _bits(verts)) != 0).any(-1)


def mis_greedy_update(bitmap: torch.Tensor, count: torch.Tensor,
                      emb: torch.Tensor, n_valid: torch.Tensor,
                      tau: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy maximal-independent-set selection, row order = priority.

    The plain version of the mis_bitmap kernel: a loop over each pattern's
    valid rows.  bitmap (P, Nw) int32 words; count/n_valid/tau (P,) int32;
    emb (P, cap, K) int32 with the first `k` columns valid.  A row is taken
    iff it is valid (row < n_valid), none of its vertices (−1 clipped to 0)
    is marked, and count < τ; taking it marks its vertices.  Returns new
    (bitmap, count) on the input's device; the inputs are not modified.
    """
    P, cap = emb.shape[:2]
    words = bitmap.cpu().numpy().view(np.uint32).astype(np.int64)
    rows = emb[:, :, :k].clamp(min=0).cpu().tolist()
    counts = count.cpu().tolist()
    nv = n_valid.cpu().tolist()
    taus = tau.cpu().tolist()
    for p in range(P):
        bm = words[p].tolist()
        cnt = counts[p]
        for r in range(min(max(nv[p], 0), cap)):
            if cnt >= taus[p]:
                break
            vs = rows[p][r]
            if all(not (bm[v >> 5] >> (v & 31)) & 1 for v in vs):
                for v in vs:
                    bm[v >> 5] |= 1 << (v & 31)
                cnt += 1
        words[p] = bm
        counts[p] = cnt
    out = torch.as_tensor(words.astype(np.uint32).view(np.int32))
    return (out.to(bitmap.device),
            torch.tensor(counts, dtype=torch.int32, device=count.device))


def _luby_one(bm, cnt, emb, n_valid, tau, k, n):
    cap = emb.shape[0]
    dev = emb.device
    rowid = torch.arange(cap, dtype=torch.int32, device=dev)
    vs = emb[:, :k].clamp(min=0)
    valid = rowid < n_valid
    alive = valid & ~touches_used(bm, vs)
    flat_vs = vs.reshape(-1).long()
    words = (vs >> 5).reshape(-1).long()
    bits = _bits(vs)
    while bool(alive.any()) and cnt < tau:
        prio = torch.where(alive, rowid, torch.full_like(rowid, cap))
        vmin = torch.full((n,), cap, dtype=torch.int32, device=dev)
        vmin = vmin.scatter_reduce(0, flat_vs, prio[:, None].expand(-1, k)
                                   .reshape(-1), "amin")
        win = alive & (vmin[vs.long()] == prio[:, None]).all(1)
        # enforce τ in priority order: only the lowest (τ − cnt) winners count
        win_rank = win.cumsum(0) - 1
        win &= win_rank < (tau - cnt)
        # winners hold disjoint, unmarked vertices: adding their bits is OR
        add = torch.where(win[:, None], bits, torch.zeros_like(bits))
        bm = bm.index_add(0, words, add.reshape(-1))
        cnt += int(win.sum())
        alive = alive & ~win & ~touches_used(bm, vs)
    return bm, cnt


def mis_luby_update(bitmap: torch.Tensor, count: torch.Tensor,
                    emb: torch.Tensor, n_valid: torch.Tensor,
                    tau: torch.Tensor, k: int, n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel-rounds mIS (priority = row index). Same set as greedy at τ = ∞.

    Each round: per-data-vertex min of alive embedding priorities
    (``scatter_reduce`` amin into a dense (n,) array), then an embedding
    wins iff it holds the min on all k of its vertices.  Winners' vertices
    are retired into the bitmap.  The τ cut keeps the lowest-priority
    winners of the final round, so exactly τ embeddings are counted.
    Shapes as `mis_greedy_update`; patterns run one after another.
    """
    P = emb.shape[0]
    nv = n_valid.cpu().tolist()
    taus = tau.cpu().tolist()
    counts = count.cpu().tolist()
    bms = []
    for p in range(P):
        bm, counts[p] = _luby_one(bitmap[p], counts[p], emb[p], nv[p],
                                  taus[p], k, n)
        bms.append(bm)
    return (torch.stack(bms),
            torch.tensor(counts, dtype=torch.int32, device=count.device))
