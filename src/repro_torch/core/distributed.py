"""Distributed FLEXIS mining — match roots sharded over a process group.

The data graph is replicated on every rank (FSM graphs are MBs; the *work*
is the search), root blocks are sharded over the ranks, and the mIS
metric's conflict resolution becomes a handful of ``all_reduce`` calls a
Luby round, for every pattern of a same-k bucket at once:

  all_reduce(MIN)  of the (P, n) per-vertex priority array
  all_reduce(SUM)  of a (P, ndev) one-hot of the ranks' win counts
                   (gloo's all_gather takes no CUDA tensors; a one-hot sum
                   gathers the same counts on both backends)
  all_reduce(SUM)  of the (P, ⌈n/32⌉) bitmap word addends
  all_reduce(MAX)  of the (P,) alive flags: the loop's one host read

The rounds themselves are `mis.luby_rounds`, which the single-card
``mis_luby`` update runs on one rank without a collective.  Priorities
are globally unique (rank · cap + local row), so the round's
winners are vertex-disjoint across ranks and summing their bitmap words is
their OR.  The words are int32 (`core/mis.py`): a disjoint bit 31 sums
correctly in two's complement.  The accepted count needs no collective of
its own: the winners' global ranks are contiguous in (rank, row) order, so
a pattern accepts ``min(Σ wins, τ − count)`` of them.

The *host loop* runs on every rank: `iter_batched_supports` keeps the
bitmaps and counts replicated, so every rank takes the same early-exit
decisions and only the collectives cross ranks.  Without an initialized
process group the mesh is one rank that makes no collective call.

Super-blocks are *logical*: a fixed run of ``blocks_per_super`` root
blocks, dispatched ``ndev`` at a time (tail dispatches padded with empty
blocks).  The schedule — and with it the priority order, the early-exit
checks and the (found, overflowed, blocks_run) accounting — does not
depend on the world size, so a `SuperBlockState` snapshotted between
super-blocks restores bit-identically at any world size.  This is the
reference's ``repro.core.distributed`` (``shard_map`` over a device mesh)
on ``torch.distributed``: NCCL on the card, gloo on the CPU (gloo also
reduces CUDA tensors, which lets several ranks share one card).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .graph import DataGraph, DeviceGraph
from .pattern import Pattern
from .plan import PatternPlan, make_plan, stack_plans
from .matcher import MatchConfig, match_block, transient_match_bytes
from . import mis as mis_lib
from . import batched as batched_lib
from ..device import resolve_device

__all__ = ["MiningMesh", "mining_mesh", "process_rank", "world_any",
           "sharded_mis_step", "distributed_support",
           "sharded_batched_mis_step", "distributed_batched_supports",
           "SuperBlockState", "iter_batched_supports",
           "evaluate_level_distributed", "COUNTERS", "reset_counters",
           "time_collectives", "collective_device_ms"]

# what the plane did since `reset_counters`: dispatches (sharded steps),
# Luby rounds, all_reduce calls and their bytes
COUNTERS = {"dispatches": 0, "luby_rounds": 0, "all_reduce": 0,
            "all_reduce_bytes": 0}
# CUDA event pairs around each all_reduce, while `time_collectives(True)`
_EVENTS: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
_TIMING = [False]


def reset_counters() -> None:
    for key in COUNTERS:
        COUNTERS[key] = 0
    _EVENTS.clear()


def time_collectives(on: bool) -> None:
    """Record a CUDA event pair around every all_reduce of a CUDA tensor
    (`collective_device_ms` sums them)."""
    _TIMING[0] = bool(on)


def collective_device_ms() -> float:
    """Device time of the all_reduce calls recorded since `reset_counters`
    (synchronizes the card)."""
    if not _EVENTS:
        return 0.0
    torch.cuda.synchronize()
    return float(sum(a.elapsed_time(b) for a, b in _EVENTS))


class MiningMesh:
    """The ranks that share the mining work: the reference's 1-D mesh.

    ``rank`` is the reference's ``axis_index``, ``world_size`` its device
    count; ``device`` is where this rank's tensors live (``cuda:LOCAL_RANK``
    under NCCL).  ``group`` None is the mesh of one rank without a process
    group, which makes no collective call.
    """

    def __init__(self, group, rank: int, world_size: int,
                 device: torch.device):
        self.group = group
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = device

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """Reduce ``t`` in place over the mesh (nothing without a group)."""
        if self.group is None:
            return t
        COUNTERS["all_reduce"] += 1
        COUNTERS["all_reduce_bytes"] += t.numel() * t.element_size()
        if _TIMING[0] and t.is_cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dist.all_reduce(t, op=op, group=self.group)
            b.record()
            _EVENTS.append((a, b))
        else:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on some rank."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        return bool(self.all_reduce(t, dist.ReduceOp.MAX).item())


def mining_mesh(device="cuda") -> MiningMesh:
    """The mesh over the initialized default process group, or a mesh of
    one rank on ``device`` when no group is initialized.

    Under NCCL the rank's device is ``cuda:LOCAL_RANK`` (else the current
    card); under gloo it is ``device``, on the CPU or on a card.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return MiningMesh(None, 0, 1, resolve_device(device))
    group = dist.group.WORLD
    if dist.get_backend(group) == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("an NCCL process group mines on the card; "
                             "pass device='cuda' (or use gloo on the CPU)")
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else torch.cuda.current_device())
    else:
        dev = resolve_device(device)
    return MiningMesh(group, dist.get_rank(group), dist.get_world_size(group),
                      dev)


def process_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def world_any(flag: bool) -> bool:
    """`MiningMesh.any` over the default group (the flag itself without
    one): ranks that must stop together agree on it first."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return bool(flag)
    return mining_mesh("cuda" if dist.get_backend() == "nccl"
                       else "cpu").any(flag)


def _luby_rounds_global(mesh: MiningMesh, bitmaps: torch.Tensor,
                        counts: torch.Tensor, emb: torch.Tensor,
                        n_valid: torch.Tensor, taus: torch.Tensor, k: int,
                        n: int, cap: int):
    """Globally synchronized Luby rounds for a bucket of P patterns
    (`mis.luby_rounds` over the mesh): bitmaps and counts replicated, emb
    and n_valid this rank's.  Returns new (bitmaps, counts)."""
    bitmaps, counts, rounds = mis_lib.luby_rounds(
        bitmaps, counts, emb, n_valid, taus, k, n, cap, mesh=mesh)
    COUNTERS["luby_rounds"] += rounds
    return bitmaps, counts


def sharded_batched_mis_step(mesh: MiningMesh, g: DeviceGraph,
                             plans: PatternPlan, block_starts, bitmaps,
                             counts, taus, *, cfg: MatchConfig, k: int,
                             n: int):
    """One distributed step for a whole same-k candidate batch.

    Every rank matches its own root block (``block_starts[rank]``; a start
    ≥ n matches no root) for the stacked ``plans`` — on a CUDA graph each
    expansion level is one launch of the frontier kernel — then the mesh
    resolves mIS conflicts globally.  Returns (bitmaps, counts, found,
    overflowed, peak): found summed, overflow OR-ed and peak occupancy
    max-ed over the mesh, each (P,).
    """
    emb, n_valid, found, ovf, peak = match_block(
        g, plans, int(block_starts[mesh.rank]), cfg)
    bitmaps, counts = _luby_rounds_global(mesh, bitmaps, counts, emb,
                                          n_valid, taus, k, n, cfg.cap)
    summed = torch.stack([found.to(torch.int32), ovf.to(torch.int32)])
    mesh.all_reduce(summed, dist.ReduceOp.SUM)
    peak = peak.to(torch.int32).clone()
    mesh.all_reduce(peak, dist.ReduceOp.MAX)
    COUNTERS["dispatches"] += 1
    return bitmaps, counts, summed[0], summed[1] > 0, peak


def sharded_mis_step(mesh: MiningMesh, g: DeviceGraph, plan: PatternPlan,
                     block_starts, bitmap, count, tau, *, cfg: MatchConfig,
                     k: int, n: int):
    """`sharded_batched_mis_step` for one pattern: bitmap (⌈n/32⌉,), count
    and tau scalars; ``plan`` stacked with P = 1.  Returns (bitmap, count,
    found)."""
    bm, cnt, found, _, _ = sharded_batched_mis_step(
        mesh, g, plan, block_starts, bitmap[None], count.reshape(1),
        tau.reshape(1), cfg=cfg, k=k, n=n)
    return bm[0], cnt[0], found[0]


# ---------------------------------------------------------------------------
# resumable super-block schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SuperBlockState:
    """Carried state of a batched distributed run between super-blocks.

    The unit the session runtime checkpoints: ``bitmaps``/``counts`` are
    the mIS metric state as *full logical tensors*, replicated on every
    rank, so a restore at any world size hands the same tensors back.  The
    rest are host accumulators plus the ``next_block`` cursor (in
    schedule positions).
    """

    next_block: int               # next schedule position (block-order index)
    bitmaps: Any                  # (P, ⌈n/32⌉) int32 words — replicated
    counts: Any                   # (P,) int32
    found: np.ndarray             # (P,) int64, frozen per pattern at τ
    overflowed: np.ndarray        # (P,) bool
    blocks_run: np.ndarray        # (P,) int64, frozen per pattern at τ
    super_blocks_run: int = 0
    dispatches: int = 0           # sharded step invocations (telemetry)
    max_count: Optional[np.ndarray] = None  # (P,) int64 peak occupancy

    def supports(self) -> np.ndarray:
        return np.asarray(torch.as_tensor(self.counts).cpu(), np.int64)


def _init_super_block_state(P_: int, n: int, device="cpu") -> SuperBlockState:
    return SuperBlockState(
        next_block=0,
        bitmaps=torch.zeros((P_, mis_lib.bitmap_words(n)), dtype=torch.int32,
                            device=device),
        counts=torch.zeros((P_,), dtype=torch.int32, device=device),
        found=np.zeros(P_, np.int64),
        overflowed=np.zeros(P_, bool),
        blocks_run=np.zeros(P_, np.int64),
        max_count=np.zeros(P_, np.int64),
    )


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` name one card."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def _setup(host_g: DataGraph, mesh: Optional[MiningMesh], device,
           dev_g: Optional[DeviceGraph], match_cfg: Optional[MatchConfig]):
    mesh = mesh if mesh is not None else mining_mesh(device)
    if dev_g is None or not _same_device(dev_g.device, mesh.device):
        dev_g = DeviceGraph.from_host(host_g, mesh.device)
    cfg = match_cfg or MatchConfig.for_graph(host_g)
    return mesh, dev_g, cfg


def iter_batched_supports(
    host_g: DataGraph,
    patterns: Sequence[Pattern],
    taus: Sequence[int],
    *,
    mesh: Optional[MiningMesh] = None,
    device="cuda",
    dev_g: Optional[DeviceGraph] = None,
    match_cfg: Optional[MatchConfig] = None,
    complete: bool = False,
    blocks_per_super: Optional[int] = None,
    state: Optional[SuperBlockState] = None,
    block_order: Optional[np.ndarray] = None,
) -> Iterator[SuperBlockState]:
    """Mine a same-k batch one *logical* super-block at a time.

    Yields the carried `SuperBlockState` after every super-block; the
    caller may stop at any yield, snapshot the state, and rebuild the
    iterator with ``state=`` to continue — at the same or another world
    size — with bit-identical counts, bitmaps and accounting.

    ``mesh`` defaults to `mining_mesh(device)`; ``dev_g`` is the graph on
    the mesh's device (built when omitted).  ``blocks_per_super`` fixes the
    super-block width in root blocks (default: the world size).  τ early
    exit and the per-pattern (found, overflowed, blocks_run) freeze happen
    at super-block boundaries.  ``block_order`` is the static root-block
    schedule (`planner.root_block_order`; None = vertex-id order); the
    cursor indexes into it.
    """
    assert len(patterns) == len(taus) and len(patterns) > 0
    k = patterns[0].k
    assert all(p.k == k for p in patterns), "batch must share pattern size"
    mesh, dev_g, cfg = _setup(host_g, mesh, device, dev_g, match_cfg)
    dev = mesh.device
    ndev = mesh.world_size
    plans = stack_plans([make_plan(p, host_g) for p in patterns], dev)
    n = host_g.n
    P_ = len(patterns)
    taus_np = np.asarray(taus, np.int64)
    bps = ndev if blocks_per_super is None else int(blocks_per_super)
    assert bps >= 1

    int32_max = np.iinfo(np.int32).max
    tau_full = np.full(P_, int32_max, np.int64) if complete else taus_np
    tau_dev = torch.as_tensor(np.minimum(tau_full, int32_max).astype(np.int32),
                              device=dev)

    if state is None:
        state = _init_super_block_state(P_, n, dev)
    # a restored state carries host or other-device tensors
    bitmaps = torch.as_tensor(state.bitmaps).to(dev, torch.int32, copy=True)
    counts = torch.as_tensor(state.counts).to(dev, torch.int32, copy=True)
    assert tuple(bitmaps.shape) == (P_, mis_lib.bitmap_words(n)), bitmaps.shape
    found = state.found.copy()
    ovf = state.overflowed.copy()
    blocks_run = state.blocks_run.copy()
    max_count = (np.zeros(P_, np.int64) if state.max_count is None
                 else state.max_count.copy())
    next_block = int(state.next_block)
    super_blocks = int(state.super_blocks_run)
    dispatches = int(state.dispatches)

    n_blocks = -(-n // cfg.root_block)
    if block_order is None:
        block_order = np.arange(n_blocks, dtype=np.int64)
    assert block_order.shape[0] == n_blocks
    while next_block < n_blocks:
        counts_np = counts.cpu().numpy().astype(np.int64)
        if not complete and bool((counts_np >= taus_np).all()):
            return
        # per-pattern freeze at super-block granularity: a pattern past τ
        # stops accumulating telemetry (its device state is frozen anyway
        # by the count < τ guard of the Luby rounds)
        active = np.ones(P_, bool) if complete else counts_np < taus_np
        stop = min(next_block + bps, n_blocks)
        sb = []
        for lo in range(next_block, stop, ndev):
            # tail dispatches padded with empty blocks (start n matches no
            # root), so a super-block never leaks into the next one
            pos = lo + np.arange(ndev)
            ids = block_order[np.minimum(pos, n_blocks - 1)]
            starts = np.where(pos < stop, ids * cfg.root_block, n)
            bitmaps, counts, d_found, d_ovf, d_peak = sharded_batched_mis_step(
                mesh, dev_g, plans, starts, bitmaps, counts, tau_dev,
                cfg=cfg, k=k, n=n)
            sb.append(torch.stack([d_found, d_ovf.to(torch.int32), d_peak]))
            dispatches += 1
        host = torch.stack(sb).cpu().numpy().astype(np.int64)   # (D, 3, P)
        sb_found = host[:, 0].sum(0)
        sb_ovf = host[:, 1].any(0)
        sb_peak = host[:, 2].max(0)
        found[active] += sb_found[active]
        ovf[active] |= sb_ovf[active]
        blocks_run[active] += stop - next_block
        max_count[active] = np.maximum(max_count[active], sb_peak[active])
        next_block = stop
        super_blocks += 1
        state = SuperBlockState(
            next_block=next_block, bitmaps=bitmaps, counts=counts,
            found=found.copy(), overflowed=ovf.copy(),
            blocks_run=blocks_run.copy(), super_blocks_run=super_blocks,
            dispatches=dispatches, max_count=max_count.copy())
        yield state


def distributed_batched_supports(
    host_g: DataGraph,
    patterns: Sequence[Pattern],
    taus: Sequence[int],
    *,
    mesh: Optional[MiningMesh] = None,
    device="cuda",
    match_cfg: Optional[MatchConfig] = None,
    complete: bool = False,
    blocks_per_super: Optional[int] = None,
    state: Optional[SuperBlockState] = None,
    return_state: bool = False,
):
    """mIS supports of a same-k candidate batch, mined across the mesh.

    Returns (supports, found), each (P,) — or (supports, found, state) with
    ``return_state=True``.  Drives `iter_batched_supports` to completion;
    pass ``state=`` to continue a snapshotted run.
    """
    mesh, dev_g, cfg = _setup(host_g, mesh, device, None, match_cfg)
    last = state if state is not None else _init_super_block_state(
        len(patterns), host_g.n, mesh.device)
    for last in iter_batched_supports(
            host_g, patterns, taus, mesh=mesh, dev_g=dev_g, match_cfg=cfg,
            complete=complete, blocks_per_super=blocks_per_super,
            state=state):
        pass
    if return_state:
        return last.supports(), last.found, last
    return last.supports(), last.found


def evaluate_level_distributed(
    host_g: DataGraph,
    patterns: Sequence[Pattern],
    taus: Sequence[int],
    cfg: MatchConfig,
    *,
    mesh: Optional[MiningMesh] = None,
    device="cuda",
    dev_g: Optional[DeviceGraph] = None,
    complete: bool = False,
    deadline: Optional[float] = None,
    max_batch: int = batched_lib.DEFAULT_MAX_BATCH,
    blocks_per_super: Optional[int] = None,
    hooks=None,
    block_order: Optional[np.ndarray] = None,
) -> Tuple[List[Optional["batched_lib.PatternOutcome"]], bool,
           "batched_lib.LevelTelemetry"]:
    """Evaluate a whole candidate level on the mesh (mIS/Luby semantics).

    The distributed counterpart of `batched.evaluate_level_batched`: the
    level is cut into the same (k, lo) groups, each group is mined by
    `iter_batched_supports` (roots sharded × patterns batched), and the
    same duck-typed ``hooks`` surface drives mid-level resume at
    super-block granularity, with `SuperBlockState` as the carried unit.

    The deadline is checked between super-blocks, and the ranks agree on
    it (a rank alone past it would leave the others in a collective); an
    interrupted group reports ``None`` for every pattern in flight.
    """
    assert len(patterns) == len(taus)
    # the mesh-failure fault point: an `error` here exercises `mine()`'s
    # distributed → batched fallback (lazy import: core/ does not need
    # runtime/ at import time)
    from ..runtime import faults as _faults

    _faults.fire("level.distributed")
    mesh, dev_g, cfg = _setup(host_g, mesh, device, dev_g, cfg)
    n = host_g.n
    outcomes: List[Optional[batched_lib.PatternOutcome]] = [None] * len(patterns)
    prefilled = hooks.resume_outcomes() if hooks is not None else None

    timed_out = False
    telemetry = batched_lib.LevelTelemetry()
    if hooks is not None:
        telemetry.dispatches = int(hooks.resume_dispatches())
    for k, lo, idxs in batched_lib.level_groups(patterns, max_batch):
        telemetry.state_bytes = max(
            telemetry.state_bytes,
            len(idxs) * (batched_lib._state_bytes("mis_luby", k, n)
                         + transient_match_bytes(cfg, k)))
        if prefilled is not None and all(i in prefilled for i in idxs):
            for i in idxs:
                outcomes[i] = prefilled[i]
            continue
        group_pats = [patterns[i] for i in idxs]
        group_taus = [taus[i] for i in idxs]
        state = hooks.group_resume(k, lo) if hooks is not None else None
        group_timed_out = False
        it = iter_batched_supports(
            host_g, group_pats, group_taus, mesh=mesh, dev_g=dev_g,
            match_cfg=cfg, complete=complete,
            blocks_per_super=blocks_per_super, state=state,
            block_order=block_order)
        last = state if state is not None else _init_super_block_state(
            len(idxs), n, mesh.device)
        while True:
            if deadline is not None \
                    and mesh.any(time.monotonic() > deadline):
                group_timed_out = True
                break
            try:
                last = next(it)
            except StopIteration:
                break
            if hooks is not None:
                hooks.on_group_state(k, lo, last)
        telemetry.dispatches += int(last.dispatches)
        if group_timed_out:
            timed_out = True
            break
        sups = last.supports()
        last_max = (last.max_count if last.max_count is not None
                    else np.zeros(len(idxs), np.int64))
        got = [
            batched_lib.PatternOutcome(
                support=int(sups[j]),
                frequent=bool(sups[j] >= group_taus[j]),
                embeddings_found=int(last.found[j]),
                overflowed=bool(last.overflowed[j]),
                blocks_run=int(last.blocks_run[j]),
                max_count=int(last_max[j]),
            )
            for j in range(len(idxs))
        ]
        for i, out in zip(idxs, got):
            outcomes[i] = out
        if hooks is not None:
            hooks.on_group_done(k, lo, idxs, got, int(last.dispatches))
    assert timed_out or all(o is not None for o in outcomes)
    for o in outcomes:
        if o is not None:
            telemetry.max_count = max(telemetry.max_count, o.max_count)
            telemetry.overflowed |= o.overflowed
    return outcomes, timed_out, telemetry


def distributed_support(
    host_g: DataGraph,
    pat: Pattern,
    tau: int,
    *,
    mesh: Optional[MiningMesh] = None,
    device="cuda",
    match_cfg: Optional[MatchConfig] = None,
    complete: bool = False,
) -> Tuple[int, int]:
    """mIS support of one pattern, mined across the mesh.

    Returns (support, embeddings_found).  Semantics match the single-card
    ``evaluate_pattern(metric="mis_luby")``: the complete run yields the
    lexicographically-first maximal independent set in global priority
    order.  Blocks go out in vertex-id order, ``ndev`` at a time.
    """
    mesh, dev_g, cfg = _setup(host_g, mesh, device, None, match_cfg)
    dev = mesh.device
    ndev = mesh.world_size
    plan = stack_plans([make_plan(pat, host_g)], dev)
    n = host_g.n
    bitmap = mis_lib.bitmap_init(n, dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    tau_dev = torch.tensor(np.iinfo(np.int32).max if complete else tau,
                           dtype=torch.int32, device=dev)
    found_total = 0

    stride = ndev * cfg.root_block
    n_super = -(-n // stride)
    for s in range(n_super):
        starts = s * stride + np.arange(ndev) * cfg.root_block
        bitmap, count, found = sharded_mis_step(
            mesh, dev_g, plan, starts, bitmap, count, tau_dev,
            cfg=cfg, k=pat.k, n=n)
        found_total += int(found)
        if not complete and int(count) >= tau:
            break
    return int(count), found_total
