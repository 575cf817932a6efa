"""Batched level-wise mining — a whole same-k candidate group per step.

A mining level holds tens to hundreds of same-size candidates, and
``match_block`` is dataflow over *plan tensors* — so a whole group runs as
one step: plans stack into a leading pattern axis P (``plan.stack_plans``),
the data graph is shared, and the metric state (mIS bitmaps/counters, MNI
image tables, fractional count tables) carries the same leading axis.  On the
card each expansion level of a step is one launch of the frontier kernel and
each greedy-mIS update one launch of the mis_bitmap kernel, for the whole
bucket.

τ early exit stays *per pattern*: after every root block the host reads the
batched support values, snapshots finished patterns out of the active set,
and — once the active set has halved — re-stacks the survivors into a
smaller power-of-two bucket.  A finished pattern wastes at most one extra
block of masked work (its ``count < τ`` guard freezes its mIS state).

Per-pattern results are bit-identical to the sequential oracle and to the
reference's batched plane for ``mis``, ``mis_luby``, ``mni`` and ``frac``,
because each pattern sees the exact same (block, update) history.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .graph import DataGraph, DeviceGraph
from .pattern import Pattern
from .plan import PatternPlan, make_plan, select_plans, stack_plans
from .matcher import MatchConfig, match_block, transient_match_bytes
from . import mis as mis_lib
from . import metrics as metrics_lib

__all__ = [
    "GroupState", "LevelTelemetry", "PatternOutcome",
    "evaluate_level_batched", "level_groups", "stack_plans",
]

_BATCHABLE_METRICS = ("mis", "mis_luby", "mni", "frac")
# metrics whose sequential loop early-exits on support >= tau
_EARLY_EXIT_METRICS = ("mis", "mis_luby", "mni")

_INT32_MAX = np.iinfo(np.int32).max

# default ceiling on the pattern axis: transient match memory is
# O(P · cap · chunk), so an unbounded level would multiply device footprint
DEFAULT_MAX_BATCH = 64


# ---------------------------------------------------------------------------
# the block step: one per (metric, k, match geometry)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _step_fn(metric: str, k: int, cfg: MatchConfig):
    """Batched block step for one (metric, k, match geometry).

    Signature of the returned callable:
        step(dev_g, plans, block_start, state, taus)
            -> (state', values, found, overflowed, peaks)

    Shapes/dtypes (P = padded pattern-bucket size, n = graph vertices):
      dev_g:   DeviceGraph (shared by the P patterns).
      plans:   PatternPlan with a leading P axis (`stack_plans`).
      block_start: python int — shared root-block offset.
      state:   metric state, leading P axis —
               mis/mis_luby: ((P, ⌈n/32⌉) int32 bitmaps, (P,) int32 counts)
               mni: (P, k, n) bool image tables
               frac: (P, k, n) float32 count tables.
      taus:    (P,) int32 device-side freeze guard (mis/mis_luby only).
      values:  (P,) running support — int32 counts/minima, float32 mass.
      found:   (P,) int32; overflowed: (P,) bool; peaks: (P,) int32.

    The ``"mis"`` update goes through the mis_bitmap kernel's wrapper: the
    kernel on the card, its plain version on the CPU.
    """
    if metric in ("mis", "mis_luby"):

        def step(g, plans, block_start, state, taus):
            from ..kernels.mis_bitmap.ops import mis_greedy_update_kernel

            bitmaps, counts = state
            emb, n_valid, found, ovf, peak = match_block(
                g, plans, block_start, cfg)
            if metric == "mis":
                bitmaps, counts = mis_greedy_update_kernel(
                    bitmaps, counts, emb, n_valid, taus, k)
            else:
                bitmaps, counts = mis_lib.mis_luby_update(
                    bitmaps, counts, emb, n_valid, taus, k, g.n)
            return (bitmaps, counts), counts, found, ovf, peak

    elif metric in ("mni", "frac"):

        def step(g, plans, block_start, table, taus):
            del taus  # MNI/frac need no device-side τ; the host owns early exit
            emb, n_valid, found, ovf, peak = match_block(
                g, plans, block_start, cfg)
            if metric == "mni":
                table = metrics_lib.mni_update(table, emb, n_valid, k)
                value = metrics_lib.mni_value(table)
            else:
                table = metrics_lib.frac_update(table, emb, n_valid, k)
                value = metrics_lib.frac_value(table)
            return table, value, found, ovf, peak

    else:
        raise ValueError(f"metric {metric!r} has no batched step")

    return step


# ---------------------------------------------------------------------------
# batched metric state
# ---------------------------------------------------------------------------

def _state_init(metric: str, P: int, k: int, n: int, device="cpu"):
    """Zeroed metric state with a leading P pattern axis (see `_step_fn`)."""
    if metric in ("mis", "mis_luby"):
        return (torch.zeros((P, mis_lib.bitmap_words(n)), dtype=torch.int32,
                            device=device),
                torch.zeros((P,), dtype=torch.int32, device=device))
    if metric == "mni":
        return torch.zeros((P, k, n), dtype=torch.bool, device=device)
    if metric == "frac":
        return torch.zeros((P, k, n), dtype=torch.float32, device=device)
    raise ValueError(metric)


def _state_bytes(metric: str, k: int, n: int) -> int:
    """Per-pattern metric-state footprint (telemetry, as the reference)."""
    if metric in ("mis", "mis_luby"):
        return mis_lib.bitmap_words(n) * 4 + 4 + (n * 4 if metric == "mis_luby" else 0)
    if metric == "mni":
        return k * n
    if metric == "frac":
        return k * n * 4
    return 0


def _gather_rows(state, sel: np.ndarray):
    if isinstance(state, tuple):
        return tuple(_gather_rows(s, sel) for s in state)
    return state.index_select(0, torch.as_tensor(sel, dtype=torch.long,
                                                 device=state.device))


def _bucket_size(n_active: int) -> int:
    return max(1, 1 << max(0, math.ceil(math.log2(max(n_active, 1)))))


# ---------------------------------------------------------------------------
# level executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PatternOutcome:
    """Per-pattern result of a batched level — mirrors the sequential
    ``evaluate_pattern`` outputs field-for-field."""
    support: int
    frequent: bool
    embeddings_found: int
    overflowed: bool
    blocks_run: int
    # max frontier occupancy observed over the blocks this pattern ran
    max_count: int = 0
    # True only for the sampled plane's estimates (not ported yet)
    estimated: bool = False


@dataclasses.dataclass
class LevelTelemetry:
    """Aggregate accounting of one level-executor call."""

    state_bytes: int = 0          # peak transient device state (pattern axis)
    dispatches: int = 0           # device steps run
    max_count: int = 0            # peak frontier occupancy across patterns
    overflowed: bool = False      # any pattern hit the frontier cap
    # per-root-block peak frontier occupancy, indexed by block id
    block_peaks: Optional[np.ndarray] = None


@dataclasses.dataclass
class GroupState:
    """Carried state of one in-flight same-k group (the batched plane's
    resume unit in the reference; here the loop's carried state)."""

    next_block: int               # next schedule position (block-order index)
    bucket_map: np.ndarray        # (P_pad,) int — group index per row, -1 pad
    state: object                 # device metric state, leading P_pad axis
    supports: np.ndarray          # (P₀,) int64
    found: np.ndarray             # (P₀,) int64
    overflowed: np.ndarray        # (P₀,) bool
    blocks_run: np.ndarray        # (P₀,) int64
    dispatches: int = 0
    max_count: Optional[np.ndarray] = None   # (P₀,) int64 peak occupancy
    block_peaks: Optional[np.ndarray] = None


def level_groups(patterns: Sequence[Pattern], max_batch: int):
    """Deterministic (k, slice-offset, indices) schedule of a level."""
    groups: dict = {}
    for i, p in enumerate(patterns):
        groups.setdefault(p.k, []).append(i)
    for k in sorted(groups):
        for lo in range(0, len(groups[k]), max_batch):
            yield k, lo, groups[k][lo:lo + max_batch]


def _mine_group(
    dev_g: DeviceGraph,
    plans: List[PatternPlan],
    taus: Sequence[int],
    metric: str,
    cfg: MatchConfig,
    *,
    complete: bool,
    n: int,
    deadline: Optional[float] = None,
    block_order: Optional[np.ndarray] = None,
) -> Tuple[List[Optional[PatternOutcome]], bool, int, np.ndarray]:
    """Run one same-k candidate group level-wise; returns
    (outcomes, timed_out, dispatches, block_peaks).

    ``block_order`` is the static root-block schedule (a permutation of
    block ids from `planner.root_block_order`; None = vertex-id order).
    Per-pattern histories reproduce the sequential loop exactly: a pattern
    accumulates (found, overflowed, blocks) for precisely the block prefix
    the sequential loop would have run, and its support is snapshotted at
    the block where it crosses τ (or at the end, for complete runs).  On a
    timeout only finished patterns get an outcome; in-flight ones get None.
    """
    P0 = len(plans)
    k = plans[0].k
    dev = dev_g.device
    early_exit = (not complete) and metric in _EARLY_EXIT_METRICS

    taus_np = np.asarray(taus, np.int64)
    # device-side τ guard: freeze mis counters at τ unless complete
    dev_tau_full = np.full(P0, _INT32_MAX if complete else 0, np.int32)
    if not complete:
        dev_tau_full[:] = np.minimum(taus_np, _INT32_MAX)

    def bucket_taus(bucket_map: np.ndarray) -> torch.Tensor:
        safe = np.where(bucket_map >= 0, bucket_map, 0)
        return torch.as_tensor(
            np.where(bucket_map >= 0, dev_tau_full[safe], 0).astype(np.int32),
            device=dev)

    total_blocks = -(-n // cfg.root_block)
    supports = np.zeros(P0, np.int64)
    found = np.zeros(P0, np.int64)
    ovf = np.zeros(P0, bool)
    blocks_run = np.zeros(P0, np.int64)
    max_count = np.zeros(P0, np.int64)
    block_peaks = np.zeros(total_blocks, np.int64)
    # current bucket: stacked plans + state + map to group idx (-1 = pad)
    P_pad = _bucket_size(P0)
    bucket_map = np.concatenate([np.arange(P0), np.full(P_pad - P0, -1)])
    state = _state_init(metric, P_pad, k, n, dev)
    dispatches = 0
    plans_cur = select_plans(stack_plans(plans, dev),
                             np.where(bucket_map >= 0, bucket_map, 0))
    taus_dev = bucket_taus(bucket_map)

    timed_out = False
    unfinished: set = set()
    if block_order is None:
        block_order = np.arange(total_blocks, dtype=np.int64)
    n_blocks = int(block_order.shape[0])
    step = _step_fn(metric, k, cfg)
    for b in range(n_blocks):
        if deadline is not None and time.monotonic() > deadline:
            timed_out = True
            unfinished = {int(i) for i in bucket_map[bucket_map >= 0]}
            break
        state, values, blk_found, blk_ovf, blk_peak = step(
            dev_g, plans_cur, int(block_order[b]) * cfg.root_block, state,
            taus_dev)
        ints = torch.stack([blk_found, blk_ovf.to(torch.int32),
                            blk_peak]).cpu().numpy()
        values_np = values.cpu().numpy()
        found_np, ovf_np, peak_np = ints[0], ints[1].astype(bool), ints[2]
        dispatches += 1

        live = bucket_map >= 0
        gi = bucket_map[live]
        found[gi] += found_np[live].astype(np.int64)
        ovf[gi] |= ovf_np[live]
        blocks_run[gi] += 1
        max_count[gi] = np.maximum(max_count[gi],
                                   peak_np[live].astype(np.int64))
        bid = int(block_order[b])
        block_peaks[bid] = max(block_peaks[bid],
                               int(peak_np[live].max(initial=0)))
        if metric == "frac":
            supports[gi] = np.floor(values_np[live].astype(np.float64)).astype(np.int64)
        else:
            supports[gi] = values_np[live].astype(np.int64)

        if early_exit:
            still = gi[supports[gi] < taus_np[gi]]
            if still.size == 0:
                break
            if still.size <= bucket_map.size // 2 and b + 1 < n_blocks:
                # shrink: re-stack survivors into the next power-of-two bucket
                pos_of = {g_idx: i for i, g_idx in enumerate(bucket_map)}
                pos = np.array([pos_of[g_idx] for g_idx in still])
                pad = _bucket_size(still.size) - still.size
                sel = np.concatenate([pos, np.full(pad, pos[0])]).astype(np.int64)
                plans_cur = select_plans(plans_cur, sel)
                state = _gather_rows(state, sel)
                bucket_map = np.concatenate([still, np.full(pad, -1)])
                taus_dev = bucket_taus(bucket_map)
            elif still.size < gi.size:
                # same bucket; just stop accounting for the finished patterns
                bucket_map = np.where(np.isin(bucket_map, still), bucket_map, -1)

    outcomes: List[Optional[PatternOutcome]] = [
        None if i in unfinished else PatternOutcome(
            support=int(supports[i]),
            frequent=bool(supports[i] >= taus_np[i]),
            embeddings_found=int(found[i]),
            overflowed=bool(ovf[i]),
            blocks_run=int(blocks_run[i]),
            max_count=int(max_count[i]),
        )
        for i in range(P0)
    ]
    return outcomes, timed_out, dispatches, block_peaks


def evaluate_level_batched(
    host_g: DataGraph,
    dev_g: DeviceGraph,
    patterns: Sequence[Pattern],
    taus: Sequence[int],
    metric: str,
    cfg: MatchConfig,
    *,
    complete: bool = False,
    deadline: Optional[float] = None,
    max_batch: int = DEFAULT_MAX_BATCH,
    block_order: Optional[np.ndarray] = None,
) -> Tuple[List[Optional[PatternOutcome]], bool, LevelTelemetry]:
    """Evaluate a whole candidate level with the batched data plane.

    Args:
      host_g/dev_g: the data graph and its device mirror (the device the
        level runs on).
      patterns: sequence of `Pattern` (sizes may mix — edge-extension
        generation); taus: same-length int thresholds.
      metric: one of ``("mis", "mis_luby", "mni", "frac")``.
      cfg: `MatchConfig` — its geometry applies to every pattern of the
        level; ``dev_g``'s device picks the kernels (CUDA) or their plain
        versions (CPU).
      complete: disable τ early exit (exact metric values).
      deadline: ``time.monotonic()`` cutoff; max_batch: pattern-axis cap.

    Candidates are grouped by k and each group split into ≤ ``max_batch``
    slices, each slice running as one batched step per root block.
    Returns (outcomes aligned with the input — ``None`` for candidates not
    reached before a timeout —, timed_out, `LevelTelemetry`).
    """
    assert len(patterns) == len(taus)
    assert metric in _BATCHABLE_METRICS, metric
    assert max_batch >= 1
    outcomes: List[Optional[PatternOutcome]] = [None] * len(patterns)
    timed_out = False
    telemetry = LevelTelemetry()
    peaks = np.zeros(-(-host_g.n // cfg.root_block), np.int64)
    for k, lo, idxs in level_groups(patterns, max_batch):
        telemetry.state_bytes = max(
            telemetry.state_bytes,
            _bucket_size(len(idxs))
            * (_state_bytes(metric, k, host_g.n)
               + transient_match_bytes(cfg, k)))
        plans = [make_plan(patterns[i], host_g) for i in idxs]
        group_taus = [taus[i] for i in idxs]
        got, group_timed_out, dispatches, group_peaks = _mine_group(
            dev_g, plans, group_taus, metric, cfg, complete=complete,
            n=host_g.n, deadline=deadline, block_order=block_order)
        telemetry.dispatches += dispatches
        peaks = np.maximum(peaks, group_peaks)
        for i, out in zip(idxs, got):
            outcomes[i] = out
        if group_timed_out:
            timed_out = True
            break
    assert timed_out or all(o is not None for o in outcomes)
    telemetry.block_peaks = peaks
    for o in outcomes:
        if o is not None:
            telemetry.max_count = max(telemetry.max_count, o.max_count)
            telemetry.overflowed |= o.overflowed
    return outcomes, timed_out, telemetry
