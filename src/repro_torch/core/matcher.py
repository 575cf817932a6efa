"""Data-parallel subgraph matcher — a frontier table advanced level by level.

VF3-Light enumerates embeddings with DFS backtracking; here a *frontier
table* of partial embeddings (a dense ``(P, cap, k)`` int32 tensor: one
``(cap, k)`` table per pattern of a same-k bucket) advances one pattern
vertex per level, in lockstep:

  level i:  anchors  = emb[:, :, anchor_pos[i]]
            cands    = chunked gather of the anchors' CSR adjacency rows
            mask     = label ∧ degree ∧ injectivity ∧ edge-checks
            emb'     = cumsum-compaction of the masked (cap × chunk) grid

Edge-existence checks run a fixed-depth branchless binary search over each
CSR row (no hash tables, no int64 keys — int32 only).

Everything is static-shaped; overflow beyond ``cap`` is *counted* and
surfaced, never silently dropped.  The host drives root *blocks* through
``match_block`` and owns early termination (τ reached).  Plans are data with
a leading pattern axis P (`plan.stack_plans`), so one call matches a whole
same-k bucket; P = 1 is the sequential plane.

The frontier's device picks the level step (`_expand_level`):

  * a CUDA frontier runs the hand-written level kernel
    (``repro_torch.kernels.frontier_expand``): one launch sequence per level
    for the whole bucket, bit-identical to the single-phase pipeline
    (survivor order included);
  * a CPU frontier runs the plain op pipeline (`_expand_level_torch`),
    two-phase when ``MatchConfig.two_phase`` is set (cheap filters →
    compact → bisect survivors only).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .graph import DataGraph, DeviceGraph
from .plan import PatternPlan

__all__ = ["MatchConfig", "match_block", "edge_exists", "transient_match_bytes"]


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Static matcher geometry (hashable & frozen; keys the step cache)."""

    cap: int = 8192          # frontier capacity (embeddings per level)
    root_block: int = 4096   # roots processed per host iteration
    chunk: int = 64          # neighbors gathered per expansion chunk
    max_chunks: int = 8      # ceil(max_degree / chunk)
    bisect_iters: int = 12   # ceil(log2(max_degree + 1))
    # two-phase expansion: run the cheap filters (label/degree/injectivity)
    # on the full (cap × chunk) grid, compact survivors, and run the
    # edge-existence bisection only on the compacted lanes.  Read by the CPU
    # pipeline only; the kernel (CUDA frontiers) is single-phase.  The two
    # differ only in which rows a level that overflows `cap` keeps, and
    # such a level is always flagged through `overflowed`.
    two_phase: bool = False

    @classmethod
    def for_graph(cls, g: DataGraph, *, cap: int = 8192, root_block: int = 4096,
                  chunk: int = 64) -> "MatchConfig":
        """Right-size the geometry to the graph: the frontier capacity and
        root blocks never usefully exceed the graph scale, and the chunk
        width never usefully exceeds the max degree."""
        max_deg = max(g.max_out_degree, g.max_in_degree, 1)
        chunk = int(min(chunk, 1 << int(np.ceil(np.log2(max_deg + 1)))))
        root_block = int(min(root_block, max(128, 1 << int(np.ceil(np.log2(g.n))))))
        cap = int(min(cap, max(1024, 1 << int(np.ceil(np.log2(g.n_edges + 1))))))
        return cls(
            cap=cap,
            root_block=root_block,
            chunk=chunk,
            max_chunks=max(1, -(-max_deg // chunk)),
            bisect_iters=max(2, int(np.ceil(np.log2(max_deg + 1))) + 1),
            two_phase=True,
        )


def transient_match_bytes(cfg: MatchConfig, k: int) -> int:
    """Transient device footprint of one match step for ONE pattern (bytes).

    Counts the two (cap, k) int32 frontier tables plus the
    (cap × chunk) candidate-expansion grid with its per-lane intermediates
    (≈ k + 8 int32 each).  The batched plane runs P patterns per step, so
    its peak is ``bucket_size(P) · transient_match_bytes(cfg, k)``.  The
    same accounting as the reference, so ``peak_device_bytes`` telemetry
    agrees between the two packages.
    """
    emb = cfg.cap * k * 4
    return emb * 2 + cfg.cap * cfg.chunk * (k + 8) * 4


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return a[idx.long()]


def edge_exists(indptr, indices, u, v, n_iters: int):
    """Branchless bounded binary search: is v in sorted indices[indptr[u]:indptr[u+1]]?

    indptr: (n+1,) int32 CSR row pointers; indices: (E,) int32 sorted within
    each row.  u, v: int32 tensors (broadcast-compatible), pre-clipped to
    [0, n).  Runs exactly ``n_iters`` iterations of the clipped search, so a
    too-small ``n_iters`` gives the same (wrong) answer as the reference.
    Returns a bool tensor of the broadcast shape.
    """
    last = indices.shape[0] - 1
    lo = _take(indptr, u)
    hi = _take(indptr, u + 1)
    # invariant: answer position (if any) in [lo, hi)
    for _ in range(n_iters):
        mid = (lo + hi) >> 1
        mid_safe = mid.clamp(0, last)
        go_right = (_take(indices, mid_safe) < v) & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
    lo_safe = lo.clamp(0, last)
    return (lo < _take(indptr, u + 1)) & (_take(indices, lo_safe) == v)


def _degrees(indptr, verts):
    return _take(indptr, verts + 1) - _take(indptr, verts)


def _init_roots(g: DeviceGraph, plans: PatternPlan, block_start,
                cfg: MatchConfig):
    """Root frontier for one block: vertices in [block_start, block_start+R)
    matching each pattern's root label + degree filters, compacted into
    (P, cap, k).  Rows past ``cap`` are dropped.

    ``block_start`` is one python int shared by the P rows (a same-k
    bucket), or a (P,) int tensor with one start per row (the blocks axis
    of `batched.collect_pattern_embeddings`: P copies of one plan); a start
    ≥ n matches no root."""
    R, cap, k = cfg.root_block, cfg.cap, plans.k
    P = plans.root_label.shape[0]
    dev = g.labels.device
    lanes = torch.arange(R, dtype=torch.int32, device=dev)
    if isinstance(block_start, torch.Tensor):
        verts = block_start.to(device=dev, dtype=torch.int32)[:, None] \
            + lanes[None]                                      # (P, R)
    else:
        verts = (int(block_start) + lanes)[None]               # (1, R)
    in_range = verts < g.n
    safe = verts.clamp(0, g.n - 1)
    ok = (
        in_range
        & (_take(g.labels, safe) == plans.root_label[:, None])
        & (_degrees(g.out_indptr, safe) >= plans.root_min_out[:, None])
        & (_degrees(g.in_indptr, safe) >= plans.root_min_in[:, None])
    )                                                          # (P, R)
    pos = ok.cumsum(1) - 1
    keep = ok & (pos < cap)
    emb = torch.full((P, cap, k), -1, dtype=torch.int32, device=dev)
    p_idx, r_idx = keep.nonzero(as_tuple=True)
    emb[p_idx, pos[p_idx, r_idx], 0] = safe.expand(P, R)[p_idx, r_idx]
    count = ok.sum(1).clamp(max=cap).to(torch.int32)
    return emb, count


def _expand_level(g: DeviceGraph, plans: PatternPlan, emb, count, level: int,
                  cfg: MatchConfig):
    """Extend every partial embedding by pattern-order vertex `level`.

    emb: (P, cap, k) int32 frontier (columns ≥ level are -1); count: (P,)
    int32 valid rows.  Returns (out_emb (P, cap, k) int32, out_count (P,)
    int32, found (P,) int32, overflowed (P,) bool); survivors are packed in
    (chunk, row, position) order — the order the greedy-mIS metric consumes.
    A CUDA frontier goes to the level kernel's wrapper, a CPU frontier to
    the plain pipeline.
    """
    if emb.device.type == "cuda":
        from ..kernels.frontier_expand.ops import frontier_expand_level

        return frontier_expand_level(g, plans, emb, count, level, cfg)
    return _expand_level_torch(g, plans, emb, count, level, cfg,
                               cfg.two_phase)


def _expand_level_torch(g: DeviceGraph, plans: PatternPlan, emb, count,
                        level: int, cfg: MatchConfig, two_phase: bool):
    """The plain op pipeline of `_expand_level`, on any device; single-phase
    it is the level kernel's plain version."""
    P, cap, k = emb.shape
    C, i, n = cfg.chunk, level, g.n
    dev = emb.device
    n_idx = g.out_indices.shape[0]
    # concatenated adjacency so out/in selection is an offset, not two gathers
    indices_cat = torch.cat([g.out_indices, g.in_indices])
    last_cat = indices_cat.shape[0] - 1
    out_deg = g.out_indptr[1:] - g.out_indptr[:-1]
    in_deg = g.in_indptr[1:] - g.in_indptr[:-1]

    ap = plans.anchor_pos[:, i].long()
    use_out = plans.anchor_out[:, i][:, None]                          # (P, 1)
    anchors = emb.gather(2, ap.view(P, 1, 1).expand(P, cap, 1))[..., 0]
    anchors_safe = anchors.clamp(0, n - 1)
    start = torch.where(use_out, _take(g.out_indptr, anchors_safe),
                        _take(g.in_indptr, anchors_safe) + n_idx)     # (P, cap)
    deg = torch.where(use_out, _take(out_deg, anchors_safe),
                      _take(in_deg, anchors_safe))
    row_valid = torch.arange(cap, device=dev)[None] < count[:, None]   # (P, cap)

    cand_label = plans.cand_label[:, i]
    min_out = plans.min_out[:, i]
    min_in = plans.min_in[:, i]
    check_out = plans.check_out[:, i]                                  # (P, k)
    check_in = plans.check_in[:, i]

    # The (P, cap, C) lane grid of a chunk is evaluated on its live lanes
    # only (valid row, lane below the anchor's degree), listed by `nonzero`
    # in (pattern, row, lane) order — the grid's row-major order, which is
    # the compaction order — so the result equals the dense grid's.
    def edge_checks(p, cand_safe, prev_rows):
        """Bool per listed lane; prev_rows (m, k) prefix rows of the lanes."""
        ok = torch.ones(cand_safe.shape, dtype=torch.bool, device=dev)
        for j in range(i):
            prev_safe = prev_rows[:, j].clamp(0, n - 1)
            co = check_out[p, j]
            ci = check_in[p, j]
            if bool(co.any()):
                ok &= edge_exists(g.out_indptr, g.out_indices, cand_safe,
                                  prev_safe, cfg.bisect_iters) | ~co
            if bool(ci.any()):
                ok &= edge_exists(g.out_indptr, g.out_indices, prev_safe,
                                  cand_safe, cfg.bisect_iters) | ~ci
        return ok

    def rank_in_pattern(p):
        """0-based rank of each listed lane among its pattern's lanes, and
        the per-pattern lane counts (lanes are sorted by pattern)."""
        per_p = torch.bincount(p, minlength=P)
        first = per_p.cumsum(0) - per_p
        return torch.arange(p.shape[0], device=dev) - first[p], per_p

    out_emb = torch.full((P, cap, k), -1, dtype=torch.int32, device=dev)
    out_count = torch.zeros(P, dtype=torch.int32, device=dev)
    found = torch.zeros(P, dtype=torch.int32, device=dev)
    ovf = torch.zeros(P, dtype=torch.bool, device=dev)
    lanes = torch.arange(C, dtype=torch.int32, device=dev)
    for c in range(cfg.max_chunks):
        off = c * C + lanes                                            # (C,)
        live = row_valid[..., None] & (off < deg[..., None])           # (P, cap, C)
        p, r, lane = live.nonzero(as_tuple=True)
        cand = _take(indices_cat, (start[p, r] + off[lane]).clamp(0, last_cat))
        cand_safe = cand.clamp(0, n - 1)
        # cheap mask: label, degrees, injectivity against the prefix
        m = _take(g.labels, cand_safe) == cand_label[p]
        m &= _take(out_deg, cand_safe) >= min_out[p]
        m &= _take(in_deg, cand_safe) >= min_in[p]
        for j in range(i):
            m &= cand != emb[p, r, j]
        p, r, cand, cand_safe = p[m], r[m], cand[m], cand_safe[m]

        if two_phase and i > 0:
            # compact cheap-filter survivors (first `cap` per pattern), bisect
            # only those lanes
            rank1, n_phase1 = rank_in_pattern(p)
            keep1 = rank1 < cap
            p, r, cand = p[keep1], r[keep1], cand_safe[keep1]
            ovf |= n_phase1 > cap  # phase-1 drop: results may be incomplete
        prev_rows = emb[p, r]                                          # (m, k)
        ok = edge_checks(p, cand if two_phase and i > 0 else cand_safe,
                         prev_rows)
        p, cand, rows = p[ok], cand[ok], prev_rows[ok]
        rank, n_new = rank_in_pattern(p)
        pos = rank + out_count[p]
        keep = pos < cap
        rows[:, i] = cand
        out_emb[p[keep], pos[keep]] = rows[keep]
        n_new = n_new.to(torch.int32)
        out_count = (out_count + n_new).clamp(max=cap)
        found = found + n_new
    return out_emb, out_count, found, ovf


def match_block(g: DeviceGraph, plans: PatternPlan, block_start: int,
                cfg: MatchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Enumerate embeddings rooted in one vertex block, for a stack of P plans.

    Args:
      g:    DeviceGraph (int32 tensors on one device).
      plans: PatternPlan with a leading pattern axis P (`stack_plans`).
      block_start: first root vertex of this block (python int), or a
            (P,) int tensor of per-row first roots (see `_init_roots`).
      cfg:  MatchConfig.

    Returns (emb, count, found, overflowed, peak), each with leading axis P:
      emb:    (P, cap, k) int32 — embeddings in pattern-order columns, row
              order = (root, discovery) order = greedy priority; invalid rows
              are -1-filled.
      count:  (P,) int32 — valid rows of `emb` (≤ cap).
      found:  (P,) int32 — embeddings enumerated in the last level before
              capacity clipping.
      overflowed: (P,) bool — some level produced more than `cap` rows.
      peak:   (P,) int32 — max frontier occupancy over all levels (root
              level included, post-clip, so ≤ cap).
    """
    emb, count = _init_roots(g, plans, block_start, cfg)
    found = count
    peak = count
    overflowed = torch.zeros_like(count, dtype=torch.bool)
    for level in range(1, plans.k):
        emb, count, lvl_found, lvl_ovf = _expand_level(
            g, plans, emb, count, level, cfg)
        overflowed = overflowed | lvl_ovf | (lvl_found > cfg.cap)
        found = lvl_found
        peak = torch.maximum(peak, count)
    return emb, count, found, overflowed, peak
