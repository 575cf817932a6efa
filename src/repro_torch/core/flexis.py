"""FLEXIS — Algorithm 1: the level-wise mining loop.

Host control plane: candidate generation (Alg 2–4), τ computation (Eq. 1),
early termination, timeout.  Device data plane: by default the execution
planner (`core/planner.py`, ``execution="auto"``) picks each level's plane
and geometry — the *batched* executor (`core/batched.py`: every same-k
candidate group of a level runs as one step per root block with per-pattern
τ masking), the paper's one-pattern-at-a-time loop (``"sequential"``,
`evaluate_pattern`, kept as the oracle), the *sampled* plane
(`core/sampled.py`) or the *distributed* plane (`core/distributed.py`:
roots sharded over the ranks of a ``torch.distributed`` process group).
``mine`` runs on ``device="cuda"`` unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .graph import DataGraph, DeviceGraph
from .health import RunHealth
from .pattern import Pattern
from .canonical import canonical_key, dedupe_patterns
from .generation import edge_extension_candidates, generate_new_patterns
from .matcher import MatchConfig, match_block, transient_match_bytes
from .plan import make_plan, stack_plans
from .planner import CostModel, ExecutionPlanner, LevelPlan
from . import planner as planner_lib
from . import batched as batched_lib
from . import sampled as sampled_lib
from . import distributed as distributed_lib
from . import mis as mis_lib
from . import metrics as metrics_lib

__all__ = ["MiningConfig", "MiningLoopState", "PatternStats", "MiningResult",
           "tau_threshold", "mine", "evaluate_pattern", "initial_candidates"]

_METRICS = ("mis", "mis_luby", "mni", "frac", "mis_exact")
_GENERATION = ("merge", "edge_ext")
_EXECUTION = ("auto", "batched", "sequential", "distributed", "sampled")
_ROOT_ORDERS = ("degree", "vertex")


@dataclasses.dataclass(frozen=True)
class MiningConfig:
    sigma: int
    lam: float = 0.4
    metric: str = "mis"            # one of _METRICS
    generation: str = "merge"      # one of _GENERATION
    max_pattern_size: int = 5
    complete: bool = False         # disable τ early exit (exact metric values)
    time_limit_s: Optional[float] = None
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    # data plane: "auto" consults the execution planner
    # (`core/planner.py`) per level — cost-model plane choice, bucket
    # sizing, and occupancy-derived matcher geometry, with every decision
    # recorded in per_level["plan"]; "batched" stacks each same-k candidate
    # group of a level into one vmapped device program; "sequential" is the
    # paper's one-pattern-at-a-time loop, kept as the equivalence oracle;
    # "distributed" shards match roots over the ranks of the process group
    # (`core/distributed.py`; a mesh of one without a group) — Luby
    # semantics, so metric must be mis_luby.
    # (mis_exact always takes the sequential path — its MIS solve is
    # host-side, though its embedding collection is block-batched.)
    # "sampled" (`core/sampled.py`) runs a weighted root-block sample per
    # level, estimates support Horvitz–Thompson-style, and escalates every
    # pattern whose confidence interval reaches τ to the exact batched
    # plane — the frequent set and its supports stay bit-identical to
    # forced batched while clearly-infrequent patterns are priced at the
    # sample fraction.
    execution: str = "auto"
    # ceiling on the pattern axis of one batched program (transient device
    # memory is O(batch · cap · chunk); bigger levels are sliced)
    batch_patterns: int = 64
    # distributed plane only: logical super-block width in root blocks —
    # fixes the early-exit/accounting schedule independent of the mesh
    # shape, which is what lets a checkpointed run resume on a different
    # world size bit-identically.  None = the current world size (legacy).
    # (Under execution="auto" the planner only *considers* the distributed
    # plane when this is set — an unpinned schedule is mesh-dependent.)
    blocks_per_super: Optional[int] = None
    # root-block schedule: "degree" dispatches blocks in descending
    # max-out-degree order so high-yield roots run first and τ early exit
    # fires sooner; "vertex" is the legacy vertex-id order.  The schedule
    # is shared by every plane and is part of the session fingerprint —
    # completed metric values are deterministic *within* a schedule
    # (mIS priority = embedding-row order along it).
    root_order: str = "degree"
    # sampled plane knobs (also consulted when execution="auto" prices a
    # sampled pass).  All of them join the session config fingerprint, so
    # a --resume with a different sample schedule raises SessionMismatch
    # instead of silently mixing two different draws.
    sample_fraction: float = 0.25   # target fraction of root blocks drawn
    confidence: float = 0.95        # nominal CI level for the estimator
    sample_seed: int = 0            # RNG key root for the per-level draws
    escalate: bool = True           # False = pure estimates (no exactness)
    sample_rounds: int = 3          # max adaptive draw rounds per level

    def __post_init__(self):
        if self.metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}")
        if self.generation not in _GENERATION:
            raise ValueError(f"generation must be one of {_GENERATION}")
        if self.execution not in _EXECUTION:
            raise ValueError(f"execution must be one of {_EXECUTION}")
        if self.execution == "distributed" and self.metric != "mis_luby":
            raise ValueError(
                'execution="distributed" resolves mIS with globally-'
                'synchronized Luby rounds; set metric="mis_luby"')
        if self.batch_patterns < 1:
            raise ValueError("batch_patterns must be >= 1")
        if self.blocks_per_super is not None and self.blocks_per_super < 1:
            raise ValueError("blocks_per_super must be >= 1 (or None)")
        if self.root_order not in _ROOT_ORDERS:
            raise ValueError(f"root_order must be one of {_ROOT_ORDERS}")
        if not (0.0 <= self.lam <= 1.0):
            raise ValueError("lambda (slider) must be in [0, 1]")
        if self.execution == "sampled" and self.metric == "mis_exact":
            raise ValueError(
                'execution="sampled" estimates from block telemetry; '
                "mis_exact's host-side MIS solve has no batched escalation "
                "target — use a batchable metric")
        if not (0.0 < self.sample_fraction <= 1.0):
            raise ValueError("sample_fraction must be in (0, 1]")
        if not (0.0 < self.confidence < 1.0):
            raise ValueError("confidence must be in (0, 1)")
        if self.sample_rounds < 1:
            raise ValueError("sample_rounds must be >= 1")


@dataclasses.dataclass
class PatternStats:
    pattern: Pattern
    support: int
    tau: int
    frequent: bool
    embeddings_found: int
    overflowed: bool
    blocks_run: int
    # peak frontier occupancy over the blocks this pattern ran (≤ cap) —
    # surfaced per level as per_level["max_count"], the planner's input
    max_count: int = 0
    # device program invocations (== blocks_run except where a dispatch
    # covers several blocks, e.g. mis_exact's batched embedding collection)
    dispatches: int = 0
    # sampled plane only: True when `support` is a Horvitz–Thompson
    # estimate clamped below τ (never True for a frequent pattern —
    # escalation recomputes those exactly)
    estimated: bool = False


@dataclasses.dataclass
class MiningResult:
    frequent: List[Tuple[Pattern, int]]
    searched: int                       # candidate patterns evaluated (Table 2)
    # per level: candidates/searched/pruned/frequent counts plus telemetry —
    # "dispatches" (device program invocations; deterministic, carried
    # across a session resume), "max_count"/"overflowed" (peak frontier
    # occupancy across the level's patterns and whether any hit the cap —
    # the planner's geometry inputs), "plan" (the planner's recorded
    # decision dict, present under execution="auto") and "wall_s" (wall
    # clock spent on the level *in this process*; excluded from resume
    # bit-identity comparisons)
    per_level: Dict[int, Dict[str, Any]]
    stats: List[PatternStats]
    elapsed_s: float
    timed_out: bool
    peak_device_bytes: int
    # every recovery/fallback/retry the run performed (overflow
    # escalations, plane fallbacks, checkpoint repairs when run under a
    # session) — results are bit-identical with or without them; see
    # `core/health.py`.  Excluded from resume bit-identity comparisons.
    health: RunHealth = dataclasses.field(default_factory=RunHealth)


@dataclasses.dataclass
class MiningLoopState:
    """The host loop's full carried state at a level boundary.

    What a session runtime snapshots: handing a `MiningLoopState` back to
    `mine()` via hooks resumes the loop where it stopped — ``cp`` is the
    candidate list of the *next* level (empty once mining finished).
    """

    level: int                          # levels already completed
    cp: List[Pattern]                   # candidates of the next level
    frequent: List[Tuple[Pattern, int]]
    stats: List[PatternStats]
    per_level: Dict[int, Dict[str, Any]]
    searched: int
    peak_bytes: int
    elapsed_s: float                    # wall time consumed up to the snapshot
    timed_out: bool = False


def tau_threshold(sigma: int, lam: float, n_vertices: int) -> int:
    """Paper Eq. (1): τ = ⌊σ(1 − 1/n)λ + σ/n⌋, clamped to ≥ 1."""
    n = max(n_vertices, 1)
    return max(1, math.floor(sigma * (1.0 - 1.0 / n) * lam + sigma / n))


def initial_candidates(g: DataGraph) -> List[Pattern]:
    """CP ← EDGES(G): the size-2 patterns actually present in the graph."""
    src = np.repeat(np.arange(g.n), np.diff(g.out_indptr))
    dst = g.out_indices
    la, lb = g.labels[src], g.labels[dst]
    pairs = np.unique(np.stack([la, lb], axis=1), axis=0) if src.size else np.zeros((0, 2), int)
    # reciprocated label pairs (u⇄v exists with these labels)
    rev_keys = set()
    if src.size:
        keys = set(zip(src.tolist(), dst.tolist()))
        mutual = np.array([(s, d) in keys and (d, s) in keys for s, d in zip(src, dst)])
        mpairs = np.unique(np.stack([la[mutual], lb[mutual]], axis=1), axis=0) if mutual.any() else np.zeros((0, 2), int)
        rev_keys = {tuple(p) for p in mpairs.tolist()}
    out: List[Pattern] = []
    for a, b in pairs.tolist():
        adj = np.zeros((2, 2), dtype=bool)
        adj[0, 1] = True
        out.append(Pattern(adj, np.array([a, b], np.int32)))
    for a, b in sorted(rev_keys):
        adj = np.zeros((2, 2), dtype=bool)
        adj[0, 1] = adj[1, 0] = True
        out.append(Pattern(adj, np.array([a, b], np.int32)))
    return dedupe_patterns(out)


def evaluate_pattern(
    host_g: DataGraph,
    dev_g: DeviceGraph,
    pat: Pattern,
    tau: int,
    cfg: MiningConfig,
    *,
    match_cfg: Optional[MatchConfig] = None,
    block_order: Optional[np.ndarray] = None,
) -> PatternStats:
    """Metric step for one candidate: stream root blocks until τ or done.

    ``match_cfg`` overrides ``cfg.match``; ``block_order`` is the static
    root-block schedule (a permutation of block ids; None = vertex-id
    order).  The pattern runs as a bucket of one (P = 1) on ``dev_g``'s
    device.  ``mis_exact`` collects embeddings with the block-batched
    collector (`batched.collect_pattern_embeddings`: the same per-block
    results, a dispatch per `MIS_EXACT_BLOCKS_PER_DISPATCH` blocks) and
    solves MIS exactly on the host.
    """
    from ..kernels.mis_bitmap.ops import mis_greedy_update_kernel

    mcfg = cfg.match if match_cfg is None else match_cfg
    dev = dev_g.device
    plan = make_plan(pat, host_g)
    k = pat.k
    n = host_g.n
    metric = cfg.metric
    early_exit_tau = torch.tensor(
        [np.iinfo(np.int32).max if cfg.complete else tau], dtype=torch.int32,
        device=dev)
    n_blocks = -(-n // mcfg.root_block)
    if block_order is None:
        block_order = np.arange(n_blocks, dtype=np.int64)

    if metric == "mis_exact":
        embs, found_total, overflowed, blocks, peak, dispatches = \
            batched_lib.collect_pattern_embeddings(
                dev_g, plan, mcfg, n, block_order=block_order)
        support = metrics_lib.exact_mis(embs)
        return PatternStats(
            pattern=pat, support=support, tau=tau,
            frequent=support >= tau, embeddings_found=found_total,
            overflowed=overflowed, blocks_run=blocks,
            max_count=peak, dispatches=dispatches)

    plans = stack_plans([plan], dev)
    if metric in ("mis", "mis_luby"):
        state = (mis_lib.bitmap_init(n, dev)[None],
                 torch.zeros(1, dtype=torch.int32, device=dev))
    elif metric == "mni":
        state = metrics_lib.mni_init(k, n, dev)[None]
    else:  # frac
        state = metrics_lib.frac_init(k, n, dev)[None]

    found_total = 0
    overflowed = False
    blocks = 0
    max_count = 0
    for b in range(n_blocks):
        emb, count, found, ovf, peak = match_block(
            dev_g, plans, int(block_order[b]) * mcfg.root_block, mcfg)
        blocks += 1
        found_total += int(found[0])
        overflowed |= bool(ovf[0])
        max_count = max(max_count, int(peak[0]))
        if metric == "mis":
            state = mis_greedy_update_kernel(state[0], state[1], emb, count,
                                             early_exit_tau, k)
            if not cfg.complete and int(state[1][0]) >= tau:
                break
        elif metric == "mis_luby":
            state = mis_lib.mis_luby_update(state[0], state[1], emb, count,
                                            early_exit_tau, k, n)
            if not cfg.complete and int(state[1][0]) >= tau:
                break
        elif metric == "mni":
            state = metrics_lib.mni_update(state, emb, count, k)
            if not cfg.complete and int(metrics_lib.mni_value(state)[0]) >= tau:
                break
        else:  # frac
            state = metrics_lib.frac_update(state, emb, count, k)

    if metric in ("mis", "mis_luby"):
        support = int(state[1][0])
    elif metric == "mni":
        support = int(metrics_lib.mni_value(state)[0])
    else:
        support = int(math.floor(float(metrics_lib.frac_value(state)[0])))

    return PatternStats(
        pattern=pat,
        support=support,
        tau=tau,
        frequent=support >= tau,
        embeddings_found=found_total,
        overflowed=overflowed,
        blocks_run=blocks,
        max_count=max_count,
        dispatches=blocks,
    )


def _device_bytes(mcfg: MatchConfig, metric: str, k: int, n: int) -> int:
    graphless = transient_match_bytes(mcfg, k)
    if metric in ("mis", "mis_luby"):
        graphless += ((n + 31) // 32) * 4 + (n * 4 if metric == "mis_luby" else 0)
    elif metric == "mni":
        graphless += k * n
    elif metric == "frac":
        graphless += k * n * 4
    elif metric == "mis_exact":
        # block-batched embedding collection stacks whole blocks' transient
        # state on the leading axis
        graphless *= batched_lib.MIS_EXACT_BLOCKS_PER_DISPATCH
    return graphless




def mine(g: DataGraph, cfg: MiningConfig, *, device="cuda", hooks=None,
         health: Optional[RunHealth] = None,
         calibration: Optional[str] = None) -> MiningResult:
    """Algorithm 1.  Returns all frequent patterns + the paper's telemetry.

    Runs on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``;
    asking for CUDA without a card raises).  ``cfg.execution`` is ``"auto"``
    (the planner picks each level's plane and geometry from the cost model
    that `planner.load_calibration(calibration)` loads), ``"batched"``,
    ``"sequential"``, ``"sampled"`` or ``"distributed"``.  With an
    initialized ``torch.distributed`` group every rank calls ``mine`` with
    the same arguments (`distributed.mining_mesh`: NCCL puts rank r on
    ``cuda:LOCAL_RANK``); the distributed plane shards each level's roots
    over the ranks and every rank returns the same result.

    ``health`` is the run's `RunHealth` (a fresh one when omitted).  Patterns
    that overflow an auto-derived (or within-level replanned) cap are re-run
    at the base cap (``overflow_escalation``), which restores forced-plane
    equality; a distributed level that fails is re-run on the batched plane
    (``plane_fallback``: supports are plane-invariant).

    ``hooks`` is a session runtime's resume surface (duck-typed):
    ``loop_resume()`` → Optional[`MiningLoopState`]; ``level_hooks(level)``
    → per-level hooks for the level executors (`batched.evaluate_level_batched`,
    `sampled.evaluate_level_sampled` and
    `distributed.evaluate_level_distributed` document them), with optional
    ``resume_plan()`` / ``record_plan(dict)``; ``on_level_end(state)`` at
    every level boundary; optional ``pin_calibration(dict) -> dict``.  A run
    resumed from any snapshot gives the uninterrupted run's result except
    wall-clock fields (``elapsed_s``, per-level ``wall_s``).
    """
    t0 = time.monotonic()
    if health is None:
        health = RunHealth()
    cost = planner_lib.load_calibration(calibration)
    mesh = distributed_lib.mining_mesh(device)
    n_devices = mesh.world_size
    if hooks is not None and hasattr(hooks, "pin_calibration"):
        # a session pins the planner inputs so a resume replans identically,
        # also at another world size (CostModel.from_dict ignores the extra
        # n_devices key)
        pinned = hooks.pin_calibration(
            {**cost.to_dict(), "n_devices": n_devices})
        cost = CostModel.from_dict(pinned)
        n_devices = int(pinned.get("n_devices", n_devices))
    planner = ExecutionPlanner(g, cfg, cost_model=cost, n_devices=n_devices)
    dev_g = DeviceGraph.from_host(g, mesh.device)
    graph_bytes = g.nbytes()

    resume = hooks.loop_resume() if hooks is not None else None
    if resume is None:
        frequent: List[Tuple[Pattern, int]] = []
        all_stats: List[PatternStats] = []
        per_level: Dict[int, Dict[str, Any]] = {}
        searched = 0
        peak_bytes = graph_bytes
        timed_out = False
        cp = initial_candidates(g)
        level = 0
        elapsed0 = 0.0
    else:
        frequent = list(resume.frequent)
        all_stats = list(resume.stats)
        per_level = dict(resume.per_level)
        searched = resume.searched
        peak_bytes = max(graph_bytes, resume.peak_bytes)
        timed_out = resume.timed_out
        cp = list(resume.cp)
        level = resume.level
        elapsed0 = resume.elapsed_s

    label_universe = sorted(set(g.labels.tolist()))
    searched_keys = {canonical_key(st.pattern) for st in all_stats}
    mis_mode = cfg.metric in ("mis", "mis_luby", "mis_exact")
    block_order = planner.block_order
    deadline = (None if cfg.time_limit_s is None
                else t0 + max(cfg.time_limit_s - elapsed0, 0.0))

    def loop_state(next_cp: List[Pattern]) -> MiningLoopState:
        return MiningLoopState(
            level=level, cp=list(next_cp), frequent=list(frequent),
            stats=list(all_stats), per_level=dict(per_level),
            searched=searched, peak_bytes=peak_bytes,
            elapsed_s=elapsed0 + (time.monotonic() - t0),
            timed_out=timed_out)

    while cp:
        level += 1
        level_t0 = time.monotonic()
        level_hooks = hooks.level_hooks(level) if hooks is not None else None
        level_frequent: List[Pattern] = []
        lvl_searched = 0
        lvl_pruned = 0
        lvl_dispatches = 0
        lvl_max_count = 0
        lvl_overflowed = False
        eval_pats: List[Pattern] = []
        eval_taus: List[int] = []
        for pat in cp:
            tau = (
                tau_threshold(cfg.sigma, cfg.lam, pat.k) if mis_mode else cfg.sigma
            )
            # paper §3.1.2 vertex bound: a frequent k-pattern needs k·τ
            # distinct data vertices under the independence property
            if mis_mode and pat.k * tau > g.n:
                lvl_pruned += 1
                continue
            eval_pats.append(pat)
            eval_taus.append(tau)

        # plan the level: a mid-level resume replays the recorded decision;
        # otherwise the planner decides from the previous level's telemetry
        plan: Optional[LevelPlan] = None
        if level_hooks is not None:
            resume_plan = getattr(level_hooks, "resume_plan", None)
            d = resume_plan() if resume_plan is not None else None
            if d is not None:
                plan = LevelPlan.from_dict(d, cfg.match)
        if plan is None:
            plan = planner.plan_level(level, eval_pats, eval_taus,
                                      prev=per_level.get(level - 1))
        if level_hooks is not None and cfg.execution in ("auto", "sampled"):
            record_plan = getattr(level_hooks, "record_plan", None)
            if record_plan is not None:
                record_plan(plan.to_dict())
        # mis_exact's MIS solve is host-side: it always runs sequentially
        plane = plan.plane if cfg.metric != "mis_exact" else "sequential"

        tel = None
        if plane in ("batched", "distributed", "sampled") and eval_pats:
            if plane == "sampled":
                outcomes, lvl_timed_out, tel = sampled_lib.evaluate_level_sampled(
                    g, dev_g, eval_pats, eval_taus, cfg.metric, plan.match,
                    sample=plan.sample, confidence=cfg.confidence,
                    escalate=cfg.escalate, complete=cfg.complete,
                    deadline=deadline, max_batch=plan.max_batch,
                    hooks=level_hooks, block_order=block_order,
                    sample_rounds=cfg.sample_rounds)
            elif plane == "distributed":
                try:
                    outcomes, lvl_timed_out, tel = \
                        distributed_lib.evaluate_level_distributed(
                            g, eval_pats, eval_taus, plan.match, mesh=mesh,
                            dev_g=dev_g, complete=cfg.complete,
                            deadline=deadline, max_batch=plan.max_batch,
                            blocks_per_super=cfg.blocks_per_super,
                            hooks=level_hooks, block_order=block_order)
                except Exception as e:
                    # a failed collective — or a mesh that can no longer
                    # satisfy the recorded plan — must not fail the query:
                    # re-run the level on the batched plane (supports are
                    # plane-invariant).  Completed groups are replayed;
                    # only the in-flight super-block cursor is dropped.
                    # `InjectedCrash` and `PreemptedError` are
                    # BaseExceptions and fly past this: a kill is not a
                    # mesh failure.
                    health.record(
                        "plane_fallback",
                        f"distributed level failed "
                        f"({type(e).__name__}: {e}); degrading to batched",
                        level=level)
                    if level_hooks is not None:
                        drop = getattr(level_hooks, "drop_inflight", None)
                        if drop is not None:
                            drop()
                    plan = dataclasses.replace(plan, plane="batched")
                    if level_hooks is not None:
                        record_plan = getattr(level_hooks, "record_plan",
                                              None)
                        if record_plan is not None:
                            # a snapshot after this point resumes on the
                            # batched plane, whatever the plan said
                            record_plan(plan.to_dict())
                    plane = "batched"
                    outcomes, lvl_timed_out, tel = \
                        batched_lib.evaluate_level_batched(
                            g, dev_g, eval_pats, eval_taus, cfg.metric,
                            plan.match, complete=cfg.complete,
                            deadline=deadline, max_batch=plan.max_batch,
                            hooks=level_hooks, block_order=block_order)
            else:
                # within-level replanning is an auto-plane behaviour: the
                # forced batched plane keeps the config geometry verbatim
                outcomes, lvl_timed_out, tel = batched_lib.evaluate_level_batched(
                    g, dev_g, eval_pats, eval_taus, cfg.metric, plan.match,
                    complete=cfg.complete, deadline=deadline,
                    max_batch=plan.max_batch, hooks=level_hooks,
                    block_order=block_order,
                    replan=cfg.execution == "auto")
            timed_out |= lvl_timed_out
            lvl_dispatches += tel.dispatches
            lvl_max_count = max(lvl_max_count, tel.max_count)
            lvl_overflowed |= tel.overflowed
            peak_bytes = max(peak_bytes, graph_bytes + tel.state_bytes)
            # overflow escalation: the planner's right-sized cap guarantees
            # headroom only over the *previous* level's peak, so a level can
            # still overflow it.  Truncation is the only cap-dependent
            # behaviour, so re-running just the overflowed patterns at the
            # base geometry restores forced-plane equality.
            esc = [i for i, o in enumerate(outcomes)
                   if o is not None and o.overflowed]
            if esc and not timed_out \
                    and (plan.match.cap < cfg.match.cap or tel.replans > 0):
                re_out, re_to, re_tel = batched_lib.evaluate_level_batched(
                    g, dev_g, [eval_pats[i] for i in esc],
                    [eval_taus[i] for i in esc], cfg.metric, cfg.match,
                    complete=cfg.complete, deadline=deadline,
                    max_batch=plan.max_batch, block_order=block_order)
                timed_out |= re_to
                lvl_dispatches += re_tel.dispatches
                peak_bytes = max(peak_bytes, graph_bytes + re_tel.state_bytes)
                outcomes = list(outcomes)
                done = 0
                for i, o in zip(esc, re_out):
                    if o is not None:
                        outcomes[i] = o
                        done += 1
                # occupancy telemetry describes the *final* outcomes (the
                # next level's plan is derived from these)
                lvl_max_count = max((o.max_count for o in outcomes
                                     if o is not None), default=0)
                lvl_overflowed = any(o.overflowed for o in outcomes
                                     if o is not None)
                health.record(
                    "overflow_escalation",
                    f"{done}/{len(esc)} patterns overflowed derived cap "
                    f"{plan.match.cap}; re-run at base cap {cfg.match.cap}",
                    level=level)
            for pat, tau, out in zip(eval_pats, eval_taus, outcomes):
                if out is None:  # level timed out before this group ran
                    continue
                st = PatternStats(
                    pattern=pat, support=out.support, tau=tau,
                    frequent=out.frequent,
                    embeddings_found=out.embeddings_found,
                    overflowed=out.overflowed, blocks_run=out.blocks_run,
                    max_count=out.max_count, estimated=out.estimated)
                searched += 1
                lvl_searched += 1
                all_stats.append(st)
                if st.frequent:
                    frequent.append((pat, st.support))
                    level_frequent.append(pat)
        else:
            seq_stats: List[PatternStats] = []
            for pat, tau in zip(eval_pats, eval_taus):
                if deadline is not None and time.monotonic() > deadline:
                    timed_out = True
                    break
                st = evaluate_pattern(g, dev_g, pat, tau, cfg,
                                      match_cfg=plan.match,
                                      block_order=block_order)
                lvl_dispatches += st.dispatches
                seq_stats.append(st)
                peak_bytes = max(
                    peak_bytes,
                    graph_bytes + _device_bytes(plan.match, cfg.metric,
                                                pat.k, g.n))
            # the same overflow escalation (auto may plan sequential levels
            # at a derived cap)
            if plan.match.cap < cfg.match.cap and not timed_out:
                n_esc = 0
                for j, st in enumerate(seq_stats):
                    if not st.overflowed:
                        continue
                    if deadline is not None and time.monotonic() > deadline:
                        timed_out = True
                        break
                    st = evaluate_pattern(g, dev_g, st.pattern, st.tau, cfg,
                                          match_cfg=cfg.match,
                                          block_order=block_order)
                    lvl_dispatches += st.dispatches
                    seq_stats[j] = st
                    n_esc += 1
                    peak_bytes = max(
                        peak_bytes,
                        graph_bytes + _device_bytes(cfg.match, cfg.metric,
                                                    st.pattern.k, g.n))
                if n_esc:
                    health.record(
                        "overflow_escalation",
                        f"{n_esc} patterns overflowed derived cap "
                        f"{plan.match.cap}; re-run at base cap "
                        f"{cfg.match.cap}", level=level)
            for st in seq_stats:
                searched += 1
                lvl_searched += 1
                lvl_max_count = max(lvl_max_count, st.max_count)
                lvl_overflowed |= st.overflowed
                all_stats.append(st)
                if st.frequent:
                    frequent.append((st.pattern, st.support))
                    level_frequent.append(st.pattern)
        per_level[level] = {
            "candidates": len(cp),
            "searched": lvl_searched,
            "pruned": lvl_pruned,
            "frequent": len(level_frequent),
            "dispatches": lvl_dispatches,
            "max_count": int(lvl_max_count),
            "overflowed": bool(lvl_overflowed),
            "wall_s": time.monotonic() - level_t0,
        }
        if cfg.execution in ("auto", "sampled"):
            per_level[level]["plan"] = plan.to_dict()
            if tel is not None and tel.sampled is not None:
                per_level[level]["sampled"] = tel.sampled
            if tel is not None and tel.block_peaks is not None:
                # block-id indexed peak occupancy — next level's draw weights
                per_level[level]["block_peaks"] = [
                    int(x) for x in tel.block_peaks]
        if cfg.execution == "auto" and tel is not None:
            per_level[level]["replans"] = int(tel.replans)
        if mesh.world_size > 1:
            # every rank runs this loop: a rank alone past the deadline
            # would leave the others waiting in the next collective
            timed_out = mesh.any(timed_out)
        if timed_out or not level_frequent:
            cp = []
        elif (cfg.generation == "merge"
              and level_frequent[0].k + 1 > cfg.max_pattern_size):
            # merge keeps strict level-wise (k−1 → k) discipline
            cp = []
        else:
            if cfg.generation == "merge":
                cp = generate_new_patterns(level_frequent)
            else:
                # edge extension mixes vertex counts (same-vertex-count
                # patterns land at different BFS levels)
                cp = edge_extension_candidates(
                    level_frequent, label_universe, max_k=cfg.max_pattern_size
                )
            searched_keys |= {canonical_key(st.pattern) for st in all_stats}
            cp = [
                p for p in cp
                if p.k <= cfg.max_pattern_size and canonical_key(p) not in searched_keys
            ]
        if hooks is not None:
            hooks.on_level_end(loop_state(cp))

    return MiningResult(
        frequent=frequent,
        searched=searched,
        per_level=per_level,
        stats=all_stats,
        elapsed_s=elapsed0 + (time.monotonic() - t0),
        timed_out=timed_out,
        peak_device_bytes=peak_bytes,
        health=health,
    )
