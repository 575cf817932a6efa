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
    "collect_pattern_embeddings", "evaluate_level_batched", "level_groups",
    "stack_plans", "MIS_EXACT_BLOCKS_PER_DISPATCH",
]

_BATCHABLE_METRICS = ("mis", "mis_luby", "mni", "frac")
# metrics whose sequential loop early-exits on support >= tau
_EARLY_EXIT_METRICS = ("mis", "mis_luby", "mni")

_INT32_MAX = np.iinfo(np.int32).max

# default ceiling on the pattern axis: transient match memory is
# O(P · cap · chunk), so an unbounded level would multiply device footprint
DEFAULT_MAX_BATCH = 64

# blocks stacked per dispatch by the mis_exact embedding collector — also
# the transient-memory multiplier `flexis._device_bytes` accounts for it
MIS_EXACT_BLOCKS_PER_DISPATCH = 8


# ---------------------------------------------------------------------------
# the block step: one per (metric, k, match geometry)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _step_fn(metric: str, k: int, cfg: MatchConfig, capture: bool = False):
    """Batched block step for one (metric, k, match geometry).

    Signature of the returned callable:
        step(dev_g, plans, block_start, state, taus)
            -> (state', values, found, overflowed, peaks)
    With ``capture=True`` two more outputs are appended — ``emb`` (P, cap,
    k) int32 and ``n_valid`` (P,) int32, `match_block`'s raw embedding
    table — which the sampled plane records per (pattern, block) so exact
    escalation can *replay* the block instead of re-matching it.

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
    update = _update_fn(metric, k)

    def step(g, plans, block_start, state, taus):
        emb, n_valid, found, ovf, peak = match_block(
            g, plans, block_start, cfg)
        state, values = update(state, emb, n_valid, taus, g.n)
        if capture:
            return state, values, found, ovf, peak, emb, n_valid
        return state, values, found, ovf, peak

    return step


@functools.lru_cache(maxsize=None)
def _update_fn(metric: str, k: int):
    """The metric update of one block step, alone:
    ``update(state, emb, n_valid, taus, n) -> (state', values)``.

    It is the whole of the update-only step that escalation uses to replay
    a recorded sample block (`_replay_step_fn`): the same embedding rows in
    the same order under the same τ guard give the same state transition
    as the matched step.  The rows past ``n_valid`` are never read, so a
    replayed table may be narrower than ``cap``.
    """
    if metric in ("mis", "mis_luby"):

        def update(state, emb, n_valid, taus, n):
            from ..kernels.mis_bitmap.ops import mis_greedy_update_kernel

            bitmaps, counts = state
            if metric == "mis":
                bitmaps, counts = mis_greedy_update_kernel(
                    bitmaps, counts, emb, n_valid, taus, k)
            else:
                bitmaps, counts = mis_lib.mis_luby_update(
                    bitmaps, counts, emb, n_valid, taus, k, n)
            return (bitmaps, counts), counts

    elif metric in ("mni", "frac"):

        def update(table, emb, n_valid, taus, n):
            del taus, n  # MNI/frac need no device-side τ; the host owns exit
            if metric == "mni":
                table = metrics_lib.mni_update(table, emb, n_valid, k)
                return table, metrics_lib.mni_value(table)
            table = metrics_lib.frac_update(table, emb, n_valid, k)
            return table, metrics_lib.frac_value(table)

    else:
        raise ValueError(f"metric {metric!r} has no batched step")

    return update


def _replay_step_fn(metric: str, k: int, n: int):
    """Update-only block step — escalation's replay of a recorded block.

    Signature: ``step(state, emb, n_valid, taus) -> (state', values)`` with
    ``emb`` (P, W, k) int32 / ``n_valid`` (P,) int32 the recorded rows of
    each pattern (W ≥ max n_valid).  The exact metric update the matched
    step applied, without the expansion: on the card the ``"mis"`` update
    is the mis_bitmap kernel fed from the recorded table.
    """
    update = _update_fn(metric, k)
    return lambda state, emb, n_valid, taus: update(state, emb, n_valid,
                                                    taus, n)


def _replay_arrays(replay, bucket_map: np.ndarray, b: int, k: int, device):
    """Assemble one replayed block's device inputs + host accounting.

    ``replay`` is the group's per-pattern replay table (group index →
    {schedule position → {"emb" (c, k) int32, "found", "ovf", "peak"}}).
    Only the recorded rows cross to the device, in one copy; the table is
    (P, W, k) with W the longest record, −1-filled on the device.  Pad rows
    (bucket_map == −1) get empty embeddings — their τ guard is 0 and their
    accounting rows are dead, exactly like pad rows of a matched step.
    """
    P = int(bucket_map.size)
    nv = np.zeros(P, np.int32)
    found = np.zeros(P, np.int32)
    ovf = np.zeros(P, bool)
    peak = np.zeros(P, np.int32)
    recs = []
    for row in range(P):
        gi = int(bucket_map[row])
        if gi < 0:
            continue
        rec = replay[gi][b]
        rows = np.asarray(rec["emb"], np.int32).reshape(-1, k)
        nv[row] = rows.shape[0]
        found[row] = int(rec["found"])
        ovf[row] = bool(rec["ovf"])
        peak[row] = int(rec["peak"])
        if rows.shape[0]:
            recs.append(rows)
    width = max(1, int(nv.max(initial=0)))
    emb = torch.full((P, width, k), -1, dtype=torch.int32, device=device)
    if recs:
        p_idx = np.repeat(np.arange(P), nv)
        r_idx = np.arange(int(nv.sum())) - np.repeat(np.cumsum(nv) - nv, nv)
        emb[torch.as_tensor(p_idx, device=device),
            torch.as_tensor(r_idx, device=device)] = torch.as_tensor(
                np.concatenate(recs)).to(device)
    return emb, nv, found, ovf, peak


def _captured_rows(emb: torch.Tensor, nv_np: np.ndarray) -> List[np.ndarray]:
    """The first ``n_valid`` rows of each pattern's (cap, k) table, as host
    int32 arrays — one device-to-host copy of the valid rows only."""
    cap = emb.shape[1]
    nv = np.clip(nv_np.astype(np.int64), 0, cap)
    valid = torch.arange(cap, device=emb.device)[None] < torch.as_tensor(
        nv, device=emb.device)[:, None]
    flat = emb[valid].cpu().numpy()
    return np.split(flat, np.cumsum(nv)[:-1])


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
    # sampled plane only: True when `support` is a Horvitz–Thompson
    # estimate (clamped below τ) rather than an exact count
    estimated: bool = False


@dataclasses.dataclass
class LevelTelemetry:
    """Aggregate accounting of one level-executor call."""

    state_bytes: int = 0          # peak transient device state (pattern axis)
    dispatches: int = 0           # device steps run
    max_count: int = 0            # peak frontier occupancy across patterns
    overflowed: bool = False      # any pattern hit the frontier cap
    # per-root-block peak frontier occupancy, indexed by block id — the
    # sampled plane's occupancy weights for the next level's draw
    block_peaks: Optional[np.ndarray] = None
    # within-level replans (auto plane only; see `_mine_group`'s ``replan``)
    replans: int = 0
    # sampled-plane summary (fraction, escalations, CI widths); None on the
    # other planes — `mine()` records it as per_level["sampled"]
    sampled: Optional[dict] = None


@dataclasses.dataclass
class GroupState:
    """Carried state of one in-flight same-k group, handed out per block.

    The batched plane's resume unit: everything `_mine_group` needs to
    continue from schedule position ``next_block`` — the (possibly
    re-stacked) active-set ``bucket_map``, the device metric state for the
    current bucket, the per-pattern host accumulators for the whole group
    (P₀-aligned), and the current (possibly replanned) frontier cap.
    """

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
    cap: Optional[int] = None
    replans: int = 0


def level_groups(patterns: Sequence[Pattern], max_batch: int):
    """Deterministic (k, slice-offset, indices) schedule of a level."""
    groups: dict = {}
    for i, p in enumerate(patterns):
        groups.setdefault(p.k, []).append(i)
    for k in sorted(groups):
        for lo in range(0, len(groups[k]), max_batch):
            yield k, lo, groups[k][lo:lo + max_batch]


def _to_device(state, device):
    """A resumed group's own copy of a snapshotted state on ``device``."""
    if isinstance(state, (tuple, list)):
        return tuple(_to_device(s, device) for s in state)
    return torch.as_tensor(state).to(device, copy=True)


def _snapshot(state):
    """A copy of the metric state: the mni/frac updates write their tables
    in place, and a handed-out `GroupState` must not move with the run."""
    if isinstance(state, tuple):
        return tuple(_snapshot(s) for s in state)
    return state.clone()


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
    resume: Optional[GroupState] = None,
    on_block=None,
    block_order: Optional[np.ndarray] = None,
    replay: Optional[List[dict]] = None,
    emb_sink=None,
    replan: bool = False,
    counters: Optional[dict] = None,
) -> Tuple[List[Optional[PatternOutcome]], bool, int, np.ndarray, int]:
    """Run one same-k candidate group level-wise; returns
    (outcomes, timed_out, dispatches, block_peaks, replans).

    ``block_order`` is the static root-block schedule (a permutation of
    block ids from `planner.root_block_order`; None = vertex-id order) or a
    *subset* of one (the sampled plane's drawn blocks); the loop cursor —
    `GroupState.next_block` included — indexes into it.

    ``replay`` (escalation reuse): per-pattern tables {schedule position →
    {"emb" (c, k) int32, "found", "ovf", "peak"}} recorded by the sample
    pass.  At a position every live pattern has a record for, the loop
    applies the recorded rows through `_replay_step_fn` instead of matching
    the block.  ``emb_sink(b, rows, n_valid, found, ovf, peak, bucket_map)``
    is the recording side: steps run in capture mode and each bucket row's
    valid embedding rows (host int32 arrays) stream to the callback.

    ``replan=True`` (auto plane only) re-derives the frontier cap at
    shrink-re-stack boundaries: when the live survivors' observed peak fits
    a smaller cap with `planner.CAP_HEADROOM`× headroom (never below
    `planner.CAP_FLOOR`, never once a live pattern overflowed), the
    remaining blocks run at the shrunk geometry.

    ``counters`` accumulates {"match_blocks", "replay_blocks"}.  ``resume``
    continues a `GroupState`; ``on_block`` receives the carried
    `GroupState` after every block that leaves the group in flight, and a
    resumed run continues bit-identically.

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
    if resume is None:
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
        start_block = 0
        dispatches = 0
        replans = 0
    else:
        supports = resume.supports.astype(np.int64).copy()
        found = resume.found.astype(np.int64).copy()
        ovf = resume.overflowed.astype(bool).copy()
        blocks_run = resume.blocks_run.astype(np.int64).copy()
        max_count = (np.zeros(P0, np.int64) if resume.max_count is None
                     else resume.max_count.astype(np.int64).copy())
        block_peaks = (np.zeros(total_blocks, np.int64)
                       if resume.block_peaks is None
                       else resume.block_peaks.astype(np.int64).copy())
        bucket_map = np.asarray(resume.bucket_map, np.int64).copy()
        state = _to_device(resume.state, dev)
        start_block = int(resume.next_block)
        dispatches = int(resume.dispatches)
        replans = int(resume.replans)
        if resume.cap is not None and int(resume.cap) != cfg.cap:
            # continue at the geometry the interrupted run had replanned to
            cfg = dataclasses.replace(cfg, cap=int(resume.cap))
    plans_cur = select_plans(stack_plans(plans, dev),
                             np.where(bucket_map >= 0, bucket_map, 0))
    taus_dev = bucket_taus(bucket_map)

    timed_out = False
    unfinished: set = set()
    if block_order is None:
        block_order = np.arange(total_blocks, dtype=np.int64)
    n_blocks = int(block_order.shape[0])
    # positions every live pattern can replay (escalation reuse) — the
    # sample pass drew level-wide, so escalated patterns share one set
    replay_at = set(replay[0].keys()) if replay else set()
    rstep = _replay_step_fn(metric, k, n) if replay_at else None
    capture = emb_sink is not None
    step = _step_fn(metric, k, cfg, capture)
    for b in range(start_block, n_blocks):
        if deadline is not None and time.monotonic() > deadline:
            timed_out = True
            unfinished = {int(i) for i in bucket_map[bucket_map >= 0]}
            break
        if b in replay_at:
            emb, nv_np, found_np, ovf_np, peak_np = _replay_arrays(
                replay, bucket_map, b, k, dev)
            state, values = rstep(state, emb, torch.as_tensor(nv_np).to(dev),
                                  taus_dev)
            values_np = values.cpu().numpy()
            if counters is not None:
                counters["replay_blocks"] = counters.get(
                    "replay_blocks", 0) + 1
        else:
            out = step(dev_g, plans_cur, int(block_order[b]) * cfg.root_block,
                       state, taus_dev)
            state, values, blk_found, blk_ovf, blk_peak = out[:5]
            host = [blk_found, blk_ovf.to(torch.int32), blk_peak]
            if capture:
                host.append(out[6])
            ints = torch.stack(host).cpu().numpy()
            values_np = values.cpu().numpy()
            found_np, ovf_np, peak_np = ints[0], ints[1].astype(bool), ints[2]
            if capture:
                nv_np = ints[3]
                emb_sink(b, _captured_rows(out[5], nv_np), nv_np, found_np,
                         ovf_np, peak_np, bucket_map)
            if counters is not None:
                counters["match_blocks"] = counters.get(
                    "match_blocks", 0) + 1
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
                if replan and not ovf[still].any():
                    # within-level replanning: the survivors' measured peak
                    # may fit a much smaller frontier cap (never once a live
                    # pattern overflowed: truncation must stay flagged)
                    from .planner import CAP_FLOOR, CAP_HEADROOM
                    live_peak = int(max_count[still].max())
                    if live_peak > 0:
                        new_cap = min(cfg.cap,
                                      max(_bucket_size(CAP_HEADROOM
                                                       * live_peak),
                                          CAP_FLOOR))
                        if new_cap < cfg.cap:
                            cfg = dataclasses.replace(cfg, cap=new_cap)
                            replans += 1
                            step = _step_fn(metric, k, cfg, capture)
            elif still.size < gi.size:
                # same bucket; just stop accounting for the finished patterns
                bucket_map = np.where(np.isin(bucket_map, still), bucket_map, -1)

        if on_block is not None and b + 1 < n_blocks:
            on_block(GroupState(
                next_block=b + 1, bucket_map=bucket_map.copy(),
                state=_snapshot(state),
                supports=supports.copy(), found=found.copy(),
                overflowed=ovf.copy(), blocks_run=blocks_run.copy(),
                dispatches=dispatches, max_count=max_count.copy(),
                block_peaks=block_peaks.copy(), cap=int(cfg.cap),
                replans=replans))

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
    return outcomes, timed_out, dispatches, block_peaks, replans


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
    hooks=None,
    block_order: Optional[np.ndarray] = None,
    replay: Optional[List[dict]] = None,
    replan: bool = False,
    counters: Optional[dict] = None,
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
      hooks: optional level-hooks object (the resume surface a session
        runtime plugs into).  Duck-typed methods — ``resume_outcomes()``:
        {pattern index → `PatternOutcome`} already computed (a group is
        skipped iff every one of its indices is present);
        ``resume_dispatches()``: dispatches already spent on skipped
        groups; ``resume_block_peaks()`` / ``resume_replans()`` (optional):
        their occupancy peaks and replans; ``group_resume(k, lo)``: the
        in-flight `GroupState` of one group, or None;
        ``on_group_state(k, lo, group_state)``: after every block of an
        unfinished group; ``on_group_done(k, lo, idxs, outcomes,
        dispatches, block_peaks=None, replans=0)``: when a group completes.
      replay/replan/counters: threaded to `_mine_group` (``replay`` aligns
        with ``patterns`` and is sliced per group).

    Candidates are grouped by k and each group split into ≤ ``max_batch``
    slices, each slice running as one batched step per root block.
    Returns (outcomes aligned with the input — ``None`` for candidates not
    reached before a timeout —, timed_out, `LevelTelemetry`).
    """
    assert len(patterns) == len(taus)
    assert metric in _BATCHABLE_METRICS, metric
    assert max_batch >= 1
    outcomes: List[Optional[PatternOutcome]] = [None] * len(patterns)
    prefilled = hooks.resume_outcomes() if hooks is not None else None

    timed_out = False
    telemetry = LevelTelemetry()
    peaks = np.zeros(-(-host_g.n // cfg.root_block), np.int64)
    if hooks is not None:
        telemetry.dispatches = int(hooks.resume_dispatches())
        rbp = getattr(hooks, "resume_block_peaks", None)
        done_peaks = rbp() if rbp is not None else None
        if done_peaks is not None:
            peaks = np.maximum(peaks, np.asarray(done_peaks, np.int64))
        rr = getattr(hooks, "resume_replans", None)
        if rr is not None:
            telemetry.replans = int(rr())
    for k, lo, idxs in level_groups(patterns, max_batch):
        # state_bytes is pure arithmetic — account skipped groups too, so a
        # resumed level reports the same peak as the uninterrupted one
        telemetry.state_bytes = max(
            telemetry.state_bytes,
            _bucket_size(len(idxs))
            * (_state_bytes(metric, k, host_g.n)
               + transient_match_bytes(cfg, k)))
        if prefilled is not None and all(i in prefilled for i in idxs):
            for i in idxs:
                outcomes[i] = prefilled[i]
            continue
        plans = [make_plan(patterns[i], host_g) for i in idxs]
        group_taus = [taus[i] for i in idxs]
        resume = hooks.group_resume(k, lo) if hooks is not None else None
        on_block = (functools.partial(hooks.on_group_state, k, lo)
                    if hooks is not None else None)
        group_replay = None if replay is None else [replay[i] for i in idxs]
        got, group_timed_out, dispatches, group_peaks, group_replans = \
            _mine_group(
                dev_g, plans, group_taus, metric, cfg,
                complete=complete, n=host_g.n, deadline=deadline,
                resume=resume, on_block=on_block, block_order=block_order,
                replay=group_replay, replan=replan, counters=counters)
        telemetry.dispatches += dispatches
        telemetry.replans += group_replans
        peaks = np.maximum(peaks, group_peaks)
        for i, out in zip(idxs, got):
            outcomes[i] = out
        if hooks is not None and not group_timed_out:
            hooks.on_group_done(k, lo, idxs, got, dispatches,
                                block_peaks=[int(x) for x in group_peaks],
                                replans=group_replans)
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


# ---------------------------------------------------------------------------
# batched embedding collection (mis_exact's device half)
# ---------------------------------------------------------------------------

def collect_pattern_embeddings(
    dev_g: DeviceGraph,
    plan: PatternPlan,
    cfg: MatchConfig,
    n: int,
    *,
    block_order: Optional[np.ndarray] = None,
    blocks_per_dispatch: int = MIS_EXACT_BLOCKS_PER_DISPATCH,
) -> Tuple[np.ndarray, int, bool, int, int, int]:
    """Enumerate EVERY block's embeddings for one pattern, batched on device.

    The device half of ``mis_exact``: the one plan is stacked
    ``blocks_per_dispatch`` times into a blocks axis and each row gets its
    own block start, so one `match_block` call — on the card one frontier
    launch per expansion level — covers that many root blocks.  Tail
    dispatches pad with ``block_start = n`` (matches no roots), so results
    are independent of the dispatch width.  Only the valid rows are copied
    to the host; the branch-and-bound MIS solve stays there.

    Returns (embeddings (m, k) int32 in schedule order, found, overflowed,
    blocks_run, max_count, dispatches) — field for field what the
    per-block sequential loop accumulates.
    """
    assert blocks_per_dispatch >= 1
    n_blocks = -(-n // cfg.root_block)
    if block_order is None:
        block_order = np.arange(n_blocks, dtype=np.int64)
    assert block_order.shape[0] == n_blocks
    dev = dev_g.device
    plans = stack_plans([plan] * blocks_per_dispatch, dev)

    chunks: List[np.ndarray] = []
    found_total = 0
    overflowed = False
    max_count = 0
    dispatches = 0
    for lo in range(0, n_blocks, blocks_per_dispatch):
        ids = np.asarray(block_order[lo: lo + blocks_per_dispatch], np.int64)
        pad = blocks_per_dispatch - ids.shape[0]
        starts = np.concatenate(
            [ids * cfg.root_block, np.full(pad, n, np.int64)])
        emb, count, found, ovf, peak = match_block(
            dev_g, plans, torch.as_tensor(starts, dtype=torch.int32,
                                          device=dev), cfg)
        dispatches += 1
        valid = ids.shape[0]
        ints = torch.stack([count, found, ovf.to(torch.int32), peak]
                           )[:, :valid].cpu().numpy()
        found_total += int(ints[1].sum())
        overflowed |= bool(ints[2].any())
        max_count = max(max_count, int(ints[3].max()))
        if ints[0].any():
            chunks.extend(r for r in _captured_rows(emb[:valid], ints[0])
                          if r.shape[0])
    embs = (np.concatenate(chunks, axis=0) if chunks
            else np.zeros((0, plan.k), np.int32))
    return embs, found_total, overflowed, n_blocks, max_count, dispatches
