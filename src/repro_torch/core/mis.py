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
    it touches (one ``scatter_reduce(..., "amin")`` per round), every
    pattern of a bucket in the same rounds (`luby_rounds`, which the
    distributed plane runs over a process group).

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
import torch.distributed as dist

__all__ = [
    "bitmap_words",
    "bitmap_init",
    "mis_greedy_update",
    "mis_luby_update",
    "luby_rounds",
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


class _OneRank:
    """The mesh of `luby_rounds` without a process group: rank 0 of 1, no
    collective."""

    rank = 0
    world_size = 1

    @staticmethod
    def all_reduce(t, op):
        return t


def luby_rounds(bitmaps: torch.Tensor, counts: torch.Tensor,
                emb: torch.Tensor, n_valid: torch.Tensor, taus: torch.Tensor,
                k: int, n: int, cap: int, mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Luby rounds for a bucket of P patterns, one set of ops a round.

    bitmaps (P, ⌈n/32⌉) int32, counts and taus (P,) int32; emb (P, cap, K)
    and n_valid (P,) are this rank's rows.  A row's priority is
    ``rank · cap + row`` (``INF = world_size · cap``); a round's winners
    hold the minimum priority on all k of their vertices.  ``mesh`` (an
    object with ``rank``, ``world_size`` and ``all_reduce(t, op)``; None =
    one rank) makes the rounds global (`core/distributed.py`): bitmaps and
    counts are replicated, the per-vertex minimum, the ranks' win counts,
    the bitmap addends and the alive flags are reduced over it.  A pattern
    with count ≥ τ or no alive row anywhere gets no winner, so a round
    leaves it as it is.  Returns new (bitmaps, counts, rounds); the inputs
    are not modified.
    """
    mesh = _OneRank if mesh is None else mesh
    P = emb.shape[0]
    dev = emb.device
    rank, ndev = mesh.rank, mesh.world_size
    INF = ndev * cap
    # rows past every pattern's n_valid are never alive: drop them (the
    # priorities keep the cap's row numbering)
    rows = max(min(int(n_valid.max()) if P else 0, cap), 0)
    rowid = torch.arange(rows, dtype=torch.int32, device=dev)
    prio_row = rank * cap + rowid
    vs = emb[:, :rows, :k].clamp(min=0)                        # (P, R, k)
    flat = vs.reshape(P, -1).long()
    words = (vs >> 5).reshape(P, -1).long()
    bits = _bits(vs)
    zero_bits = torch.zeros_like(bits)
    alive = rowid[None] < n_valid[:, None]

    def touches(bm):
        return ((bm.gather(1, words).view(P, rows, k) & bits) != 0).any(-1)

    bm, cnt = bitmaps, counts
    alive &= ~touches(bm)
    n_rounds = 0
    while True:
        flags = alive.any(1).to(torch.int32)
        mesh.all_reduce(flags, dist.ReduceOp.MAX)
        if not bool(((flags > 0) & (cnt < taus)).any()):
            break
        n_rounds += 1
        prio = torch.where(alive, prio_row[None], INF)          # (P, R)
        vmin = torch.full((P, n), INF, dtype=torch.int32, device=dev)
        vmin.scatter_reduce_(1, flat, prio[:, :, None].expand(P, rows, k)
                             .reshape(P, -1), "amin")
        mesh.all_reduce(vmin, dist.ReduceOp.MIN)
        win = alive & (vmin.gather(1, flat).view(P, rows, k)
                       == prio[:, :, None]).all(-1)
        # the τ cut in priority order: the lower ranks' wins come first
        wins = torch.zeros((P, ndev), dtype=torch.int32, device=dev)
        wins[:, rank] = win.sum(1, dtype=torch.int32)
        mesh.all_reduce(wins, dist.ReduceOp.SUM)
        room = taus - cnt
        prefix = wins[:, :rank].sum(1, dtype=torch.int32)
        win_rank = prefix[:, None] + win.cumsum(1, dtype=torch.int32) - 1
        win &= win_rank < room[:, None]
        # winners hold disjoint, unmarked vertices: adding their bits is OR
        addend = torch.zeros_like(bm)
        addend.scatter_add_(1, words, torch.where(win[:, :, None], bits,
                                                  zero_bits).reshape(P, -1))
        mesh.all_reduce(addend, dist.ReduceOp.SUM)
        bm = bm + addend
        # the winners' global ranks are contiguous: min(Σ wins, room) count
        cnt = cnt + torch.minimum(wins.sum(1, dtype=torch.int32),
                                  room).clamp(min=0)
        alive &= ~win & ~touches(bm)
    return bm, cnt, n_rounds


def mis_luby_update(bitmap: torch.Tensor, count: torch.Tensor,
                    emb: torch.Tensor, n_valid: torch.Tensor,
                    tau: torch.Tensor, k: int, n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel-rounds mIS (priority = row index). Same set as greedy at τ = ∞.

    Each round: per-data-vertex min of alive embedding priorities
    (``scatter_reduce`` amin into a dense (P, n) array), then an embedding
    wins iff it holds the min on all k of its vertices.  Winners' vertices
    are retired into the bitmap.  The τ cut keeps the lowest-priority
    winners of the final round, so exactly τ embeddings are counted.
    Shapes as `mis_greedy_update`; every pattern of the bucket runs in the
    same rounds (`luby_rounds` on one rank).
    """
    bm, cnt, _ = luby_rounds(bitmap, count.to(torch.int32), emb,
                             n_valid.to(torch.int32), tau.to(torch.int32),
                             k, n, emb.shape[1])
    return bm, cnt
