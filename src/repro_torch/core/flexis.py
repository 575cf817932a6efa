"""FLEXIS — Algorithm 1: the level-wise mining loop.

Host control plane: candidate generation (Alg 2–4), τ computation (Eq. 1),
early termination, timeout.  Device data plane: the *batched* executor
(`core/batched.py`) — every same-k candidate group of a level runs as one
step per root block with per-pattern τ masking — with the paper's
one-pattern-at-a-time loop retained as the ``execution="sequential"``
oracle (`evaluate_pattern`).  ``mine`` runs on ``device="cuda"`` unless the
caller asks for the CPU.
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
from .planner import ExecutionPlanner
from . import batched as batched_lib
from . import mis as mis_lib
from . import metrics as metrics_lib
from ..device import resolve_device

__all__ = ["MiningConfig", "PatternStats", "MiningResult", "tau_threshold",
           "mine", "evaluate_pattern", "initial_candidates"]

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
    # "distributed" shards match roots over every local device (shard_map,
    # `core/distributed.py`) — Luby semantics, so metric must be mis_luby.
    # (mis_exact always takes the sequential path — its MIS solve is
    # host-side, though its embedding collection is block-batched.)
    # "sampled" (`core/sampled.py`) runs a weighted root-block sample per
    # level, estimates support Horvitz–Thompson-style, and escalates every
    # pattern whose confidence interval reaches τ to the exact batched
    # plane — the frequent set and its supports stay bit-identical to
    # forced batched while clearly-infrequent patterns are priced at the
    # sample fraction.
    # (the port's default is "batched": "auto" needs the planner's cost
    # model, which is not ported yet)
    execution: str = "batched"
    # ceiling on the pattern axis of one batched program (transient device
    # memory is O(batch · cap · chunk); bigger levels are sliced)
    batch_patterns: int = 64
    # distributed plane only: logical super-block width in root blocks —
    # fixes the early-exit/accounting schedule independent of the mesh
    # shape, which is what lets a checkpointed run resume on a different
    # device count bit-identically.  None = current device count (legacy).
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




def _check_ported(cfg: "MiningConfig") -> None:
    if cfg.metric == "mis_exact":
        raise NotImplementedError(
            'metric="mis_exact" is not ported yet (ROADMAP Queue 1: '
            "mis_exact's batched embedding collector)")


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
    device.
    """
    _check_ported(cfg)
    from ..kernels.mis_bitmap.ops import mis_greedy_update_kernel

    mcfg = cfg.match if match_cfg is None else match_cfg
    dev = dev_g.device
    plans = stack_plans([make_plan(pat, host_g)], dev)
    k = pat.k
    n = host_g.n
    metric = cfg.metric
    early_exit_tau = torch.tensor(
        [np.iinfo(np.int32).max if cfg.complete else tau], dtype=torch.int32,
        device=dev)
    n_blocks = -(-n // mcfg.root_block)
    if block_order is None:
        block_order = np.arange(n_blocks, dtype=np.int64)

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
    return graphless


def mine(g: DataGraph, cfg: MiningConfig, *, device="cuda",
         health: Optional[RunHealth] = None) -> MiningResult:
    """Algorithm 1.  Returns all frequent patterns + the paper's telemetry.

    Runs on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``;
    asking for CUDA without a card raises).  ``cfg.execution`` must be
    ``"batched"`` or ``"sequential"``: the other planes raise
    ``NotImplementedError`` until they are ported.  Per-level telemetry
    has the reference's keys; ``wall_s`` is the host clock per level.
    """
    _check_ported(cfg)
    t0 = time.monotonic()
    if health is None:
        health = RunHealth()
    planner = ExecutionPlanner(g, cfg)
    dev_g = DeviceGraph.from_host(g, resolve_device(device))
    graph_bytes = g.nbytes()

    frequent: List[Tuple[Pattern, int]] = []
    all_stats: List[PatternStats] = []
    per_level: Dict[int, Dict[str, Any]] = {}
    searched = 0
    peak_bytes = graph_bytes
    timed_out = False
    cp = initial_candidates(g)
    level = 0

    label_universe = sorted(set(g.labels.tolist()))
    searched_keys = set()
    mis_mode = cfg.metric in ("mis", "mis_luby", "mis_exact")
    block_order = planner.block_order
    deadline = None if cfg.time_limit_s is None else t0 + cfg.time_limit_s

    while cp:
        level += 1
        level_t0 = time.monotonic()
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

        plan = planner.plan_level(level, eval_pats, eval_taus,
                                  prev=per_level.get(level - 1))
        if plan.plane == "batched" and eval_pats:
            outcomes, lvl_timed_out, tel = batched_lib.evaluate_level_batched(
                g, dev_g, eval_pats, eval_taus, cfg.metric, plan.match,
                complete=cfg.complete, deadline=deadline,
                max_batch=plan.max_batch, block_order=block_order)
            timed_out |= lvl_timed_out
            lvl_dispatches += tel.dispatches
            lvl_max_count = max(lvl_max_count, tel.max_count)
            lvl_overflowed |= tel.overflowed
            peak_bytes = max(peak_bytes, graph_bytes + tel.state_bytes)
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
            for pat, tau in zip(eval_pats, eval_taus):
                if deadline is not None and time.monotonic() > deadline:
                    timed_out = True
                    break
                st = evaluate_pattern(g, dev_g, pat, tau, cfg,
                                      match_cfg=plan.match,
                                      block_order=block_order)
                lvl_dispatches += st.dispatches
                peak_bytes = max(
                    peak_bytes,
                    graph_bytes + _device_bytes(plan.match, cfg.metric,
                                                pat.k, g.n))
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

    return MiningResult(
        frequent=frequent,
        searched=searched,
        per_level=per_level,
        stats=all_stats,
        elapsed_s=time.monotonic() - t0,
        timed_out=timed_out,
        peak_device_bytes=peak_bytes,
        health=health,
    )
