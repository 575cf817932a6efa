"""The work schedule of the bf16 flash backward at hd 64 / 128, in Python.

``csrc/flash_attention_bwd.cu``'s `flash_bwd_wgmma_kernel` runs one CTA per
work item (KV row, 128-key tile) and streams the item's live 64-row query
tiles; dQ is summed across key tiles in a fixed order through counters.
This module states the same ranges, order and ranks as the kernel's
closed forms (`w_q_range`, `w_k_range`, the ticket order, the step order)
so that the CPU tests can hold them to a brute-force enumeration, and
`simulate` plays the ordered dQ adds out to show that every chain ends
(no deadlock) in ascending key order.  `bwd_path` and `bwd_workspace` are
the wrapper's dispatch and workspace sizes (``kernel.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

TQ = 64                   # query rows a streamed tile
TK = 128                  # key rows a work item (two consumer warpgroups)
WGMMA_HEAD_DIMS = (64, 128)


def bwd_path(is_bf16: bool, hd: int) -> str:
    """Which backward kernels run: 'wgmma' (bf16, hd 64 / 128), 'mma'
    (bf16, hd 16 / 32: `mma.sync`, dQ in a second kernel) or 'f32' (the
    CUDA cores).  The C entry point makes the same choice."""
    if not is_bf16:
        return "f32"
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"


def n_tiles(S: int) -> Tuple[int, int]:
    """(query tiles of TQ rows, key tiles of TK rows) of a length-S row."""
    return -(-S // TQ), -(-S // TK)


def bwd_workspace(BH: int, S: int, hd: int, path: str) -> Dict[str, tuple]:
    """Shapes of the wrapper's scratch for ``path``: 'dvec' (f32: D, and
    for 'wgmma' lse·log2(e) too, padded to S_pad = TQ·nq rows), and for
    'wgmma' 'dq_acc' (f32 partial dQ sums) and 'sync' (int32: the ticket,
    then a counter per (head row, query tile, column half))."""
    if path != "wgmma":
        return {"dvec": (BH, S)}
    nq, _ = n_tiles(S)
    S_pad = nq * TQ
    return {"dvec": (2, BH, S_pad), "dq_acc": (BH, S_pad, hd),
            "sync": (1 + BH * nq * 2,)}


def live(qi: int, kt: int, causal: bool, window: Optional[int]) -> bool:
    """The forward's liveness test of (query tile qi, key tile kt): some
    (query, key) pair of the two tiles may attend."""
    q0, k0 = qi * TQ, kt * TK
    ok = True
    if causal:
        ok = k0 <= q0 + TQ - 1
    if window is not None:
        ok = ok and q0 - (k0 + TK - 1) < window
    return ok


def q_range(kt: int, S: int, causal: bool, window: Optional[int]
            ) -> Tuple[int, int]:
    """The live query tiles [lo, hi] of key tile kt (`w_q_range`)."""
    nq, _ = n_tiles(S)
    lo = (TK // TQ) * kt if causal else 0
    hi = nq - 1
    if window is not None:
        hi = min(hi, (window + TK * kt + TK - 2) // TQ)
    return lo, hi


def k_range(qi: int, S: int, causal: bool, window: Optional[int]
            ) -> Tuple[int, int]:
    """The live key tiles [lo, hi] of query tile qi (`w_k_range`)."""
    _, nk = n_tiles(S)
    hi = nk - 1
    if causal:
        hi = min(hi, (TQ * qi + TQ - 1) // TK)
    lo = 0
    if window is not None:
        x = TQ * qi - (TK - 1) - window
        if x >= 0:
            lo = x // TK + 1
    return lo, hi


def item(ticket: int, BKV: int) -> Tuple[int, int]:
    """(KV row, key tile) of a ticket: key tile major, so every row's lower
    key tiles (first in each dQ chain; the longest under a causal mask)
    hold earlier tickets."""
    return ticket % BKV, ticket // BKV


def steps(kt: int, S: int, G: int, causal: bool, window: Optional[int]
          ) -> List[Tuple[int, int]]:
    """The (query tile, head in group) pairs item kt visits, in order: query
    tiles from the last live one down, heads innermost."""
    lo, hi = q_range(kt, S, causal, window)
    return [(hi - i // G, i % G) for i in range((hi - lo + 1) * G)]


def dq_rank(qi: int, kt: int, S: int, causal: bool,
            window: Optional[int]) -> Tuple[int, bool]:
    """(rank, last) of key tile kt in query tile qi's dQ sum: its place
    among the tile's live key tiles in ascending order, and whether it is
    the last (which rounds the tile into dq).  The kernel keeps a counter
    for each column half of the tile, each with these ranks."""
    lo, hi = k_range(qi, S, causal, window)
    return kt - lo, kt == hi


def simulate(BKV: int, G: int, S: int, causal: bool,
             window: Optional[int], resident: int
             ) -> Dict[Tuple[int, int], List[int]]:
    """Play the kernel's ordered dQ adds out: at most ``resident`` CTAs run
    at once, each takes the next ticket when it starts, walks `steps` and,
    at each step, waits until the (head row, query tile) counter equals its
    rank, adds, and releases rank + 1.  Returns, per (head row, query
    tile), the key tiles in the order they added; raises on a deadlock
    (running CTAs that all wait)."""
    _, nk = n_tiles(S)
    n_items = BKV * nk
    counter: Dict[Tuple[int, int], int] = {}
    order: Dict[Tuple[int, int], List[int]] = {}
    running: List[list] = []        # [kvrow, kt, steps, next step]
    ticket = 0
    while ticket < n_items or running:
        while len(running) < resident and ticket < n_items:
            kvrow, kt = item(ticket, BKV)
            running.append([kvrow, kt, steps(kt, S, G, causal, window), 0])
            ticket += 1
        moved = False
        for cta in running:
            kvrow, kt, todo, i = cta
            if i == len(todo):
                continue
            qi, g = todo[i]
            key = (kvrow * G + g, qi)
            rank, _ = dq_rank(qi, kt, S, causal, window)
            if counter.get(key, 0) != rank:
                continue
            counter[key] = rank + 1
            order.setdefault(key, []).append(kt)
            cta[3] += 1
            moved = True
        done = [c for c in running if c[3] == len(c[2])]
        running = [c for c in running if c[3] < len(c[2])]
        if not moved and not done:
            raise RuntimeError(f"deadlock: {len(running)} CTAs wait")
    return order
