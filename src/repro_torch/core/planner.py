"""Adaptive execution planner — cost-model-driven level scheduling.

Every mining level asks the same three questions:

  1. **Which data plane?**  The batched plane (`core/batched.py`) amortizes
     launch and host-sync overhead across a level's candidates; when a
     single pattern's block already fills the card it is parity-or-slower
     than the sequential oracle.  The sampled plane (`core/sampled.py`)
     runs a weighted sample of root blocks and escalates what it cannot
     settle to the exact batched plane.
  2. **How wide a pattern bucket?**  Bigger buckets amortize more overhead
     but multiply transient device memory.
  3. **What matcher geometry?**  `MatchConfig.for_graph` is one graph-global
     guess; the previous level measured the actual frontier occupancy
     (``max_count``), so ``cap`` is right-sized level by level.

`ExecutionPlanner` answers all three from a small calibrated cost model
(`CostModel`, fitted on the card by ``repro_torch.launch.calibrate`` and
loaded from the port's own JSON file, with built-in defaults from an H100
fit) plus the level's observable inputs.  With ``execution="auto"``
`mine()` consults the planner at every level boundary and records the
decision in ``MiningResult.per_level[level]["plan"]``.

The decisions are host floating-point arithmetic: the formulas below repeat
the reference planner's in the same order, so the same `CostModel` gives the
same `LevelPlan`s in both packages, pricing record included.

Result-preservation contract (why "auto gives every forced plane's answer"):

  * plane choice never changes per-pattern results (batched ≡ sequential);
  * ``cap`` right-sizing preserves results whenever no level overflows the
    derived cap (truncation is the only cap-dependent behaviour and it is
    always flagged, and `mine()` re-runs flagged patterns at the base cap);
    the planner shrinks only with ≥``CAP_HEADROOM``× headroom over the
    observed peak, never below ``CAP_FLOOR``, not after an overflow;
  * ``chunk``/``max_chunks`` never change: survivors are packed in (chunk,
    row, position) order, and re-chunking would permute mIS priority;
  * ``two_phase`` toggling preserves results absent overflow.

**Degree-ordered root blocks** (`root_block_order`): blocks run in
descending max-out-degree order, so the τ early exit fires after fewer
blocks.  The permutation is a static function of (graph, root_block,
``root_order``) shared by every plane, which keeps them bit-identical.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batched import _BATCHABLE_METRICS, _bucket_size as _pow2_ceil
from .graph import DataGraph
from .matcher import MatchConfig

__all__ = [
    "CostModel", "LevelPlan", "ExecutionPlanner", "block_degree_stat",
    "root_block_order", "DEFAULT_CALIBRATION_FILE", "CALIBRATION_ENV",
    "load_calibration", "persist_escalation_fraction", "UNPORTED_PLANES",
]

# the port's calibration file (cwd-relative; override with the env var).
# Written by `repro_torch.launch.calibrate`; never the reference's file.
DEFAULT_CALIBRATION_FILE = "planner_calibration_torch.json"
CALIBRATION_ENV = "REPRO_TORCH_PLANNER_CALIBRATION"
# schema 2 added per-metric row times, schema 3 the measured escalation
# fraction; files of all three schemas load (the reference's included)
CALIBRATION_SCHEMA = 3
CALIBRATION_SCHEMAS = (1, 2, 3)

# cap right-sizing safety rails (see the module docstring)
CAP_HEADROOM = 4        # derived cap ≥ headroom × observed peak occupancy
CAP_FLOOR = 1024        # never shrink below this many frontier rows

# sampled plane: prior on the fraction of a level's batched cost the exact
# escalation pass re-spends, scaled by the unsampled fraction
ESCALATION_PRIOR = 0.25
# below this many root blocks a sample cannot both draw ≥1 block and leave
# ≥1 out — the plan falls back to the exact batched plane
MIN_SAMPLED_BLOCKS = 2
# auto picks the sampled plane only when its priced cost undercuts the
# batched row by this factor
SAMPLED_MARGIN = 0.9

# planes of the reference that need modules this port does not have yet
UNPORTED_PLANES = {
    "distributed": "ROADMAP Queue 1 item 7 (core/distributed.py)",
}


def hidden_mass_bound(confidence: float, f_cov: float) -> float:
    """Max support the unsampled blocks can hide at the CI confidence.

    Mirrors `sampled.ht_interval`'s zero-mass bound: with covered mass
    ``f_cov``, a pattern whose sample saw nothing can still hold up to
    ``ln(1−confidence)/ln(1−f_cov)`` embeddings.
    """
    if f_cov >= 1.0:
        return 0.0
    alpha = max(1e-12, 1.0 - confidence)
    return math.log(alpha) / math.log(max(1e-300, 1.0 - f_cov))


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostModel:
    """Three-term linear device-step model, plus the stacked-bucket factor.

    One batched step over a bucket of P same-k patterns costs

        dispatch_overhead_s
          + P · (lanes(cfg, k) · lane_time_s + cap · row_time_s)
              · (vmap_factor if P > 1 else 1)

    ``lanes · lane_time_s`` is the expansion grid
    (``(k−1) · cap · chunk · max_chunks`` candidate lanes); ``cap ·
    row_time_s`` the per-frontier-row metric update; ``dispatch_overhead_s``
    what a step pays whatever its geometry (launches, the host syncs of a
    step, the host loop).  The form is the reference's, fitted there on
    JAX's vmapped step; on the card a bucket is one stacked launch per
    level, and ``vmap_factor`` is the per-pattern cost of a stacked bucket
    of 4 over 4× the one-pattern step (≥ 1).  ``row_time_{mni,frac,luby}_s``
    override the mis-fitted ``row_time_s`` per metric; ``escalation_fraction``
    is the sampled plane's measured escalation share (schema 3).

    The defaults are ``repro_torch.launch.calibrate``'s fit (``--iters 50``)
    on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (``nvidia-smi``).
    Its probes are launch-bound there: every step took 0.88–1.03 ms (mis)
    whatever its geometry, so ``lane_time_s`` and the frac and luby row
    times sit at the fit's 1e-12 floor (below what the probes resolve)
    and the stacked-bucket factor at 1.
    """

    dispatch_overhead_s: float = 9.097003571412188e-04
    lane_time_s: float = 1e-12
    row_time_s: float = 2.9242372768021443e-08
    vmap_factor: float = 1.0
    row_time_mni_s: Optional[float] = 6.64471651831489e-09
    row_time_frac_s: Optional[float] = 1e-12
    row_time_luby_s: Optional[float] = 1e-12
    escalation_fraction: Optional[float] = None
    source: str = "defaults"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": CALIBRATION_SCHEMA,
            "dispatch_overhead_s": self.dispatch_overhead_s,
            "lane_time_s": self.lane_time_s,
            "row_time_s": self.row_time_s,
            "vmap_factor": self.vmap_factor,
            "row_time_mni_s": self.row_time_mni_s,
            "row_time_frac_s": self.row_time_frac_s,
            "row_time_luby_s": self.row_time_luby_s,
            "escalation_fraction": self.escalation_fraction,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CostModel":
        base = cls()

        def opt(key: str) -> Optional[float]:
            v = d.get(key)
            return None if v is None else float(v)

        try:
            return cls(
                dispatch_overhead_s=float(
                    d.get("dispatch_overhead_s", base.dispatch_overhead_s)),
                lane_time_s=float(d.get("lane_time_s", base.lane_time_s)),
                row_time_s=float(d.get("row_time_s", base.row_time_s)),
                vmap_factor=max(1.0, float(d.get("vmap_factor",
                                                 base.vmap_factor))),
                row_time_mni_s=opt("row_time_mni_s"),
                row_time_frac_s=opt("row_time_frac_s"),
                row_time_luby_s=opt("row_time_luby_s"),
                escalation_fraction=opt("escalation_fraction"),
                source=str(d.get("source", "file")),
            )
        except (TypeError, ValueError):
            return base

    def lanes(self, cfg: MatchConfig, k: int) -> int:
        return max(1, (k - 1)) * cfg.cap * cfg.chunk * cfg.max_chunks

    def row_time(self, metric: str = "mis") -> float:
        """The metric-update constant for ``metric`` (override or shared)."""
        override = {"mni": self.row_time_mni_s,
                    "frac": self.row_time_frac_s,
                    "mis_luby": self.row_time_luby_s}.get(metric)
        return self.row_time_s if override is None else override

    def pattern_work_s(self, cfg: MatchConfig, k: int,
                       metric: str = "mis") -> float:
        """Device work of ONE pattern's block step (no overhead/factor)."""
        return (self.lanes(cfg, k) * self.lane_time_s
                + cfg.cap * self.row_time(metric))

    def block_step_s(self, cfg: MatchConfig, k: int, bucket: int,
                     *, batched: bool, metric: str = "mis") -> float:
        """Predicted wall time of ONE step over one root block."""
        factor = self.vmap_factor if (batched and bucket > 1) else 1.0
        return (self.dispatch_overhead_s
                + bucket * self.pattern_work_s(cfg, k, metric) * factor)

    def esc_prior(self) -> float:
        """Escalation-mass prior: the measured fraction when calibrated,
        ESCALATION_PRIOR otherwise — clamped to [0, 1]."""
        if self.escalation_fraction is None:
            return ESCALATION_PRIOR
        return min(1.0, max(0.0, float(self.escalation_fraction)))

    def replay_step_s(self, cfg: MatchConfig, k: int, bucket: int,
                      *, metric: str = "mis") -> float:
        """Predicted wall time of ONE update-only replay step (no
        expansion-grid term)."""
        factor = self.vmap_factor if bucket > 1 else 1.0
        return (self.dispatch_overhead_s
                + bucket * cfg.cap * self.row_time(metric) * factor)


def load_calibration(path: Optional[str] = None) -> CostModel:
    """Load the fitted `CostModel`, falling back to the built-in defaults.

    Search order: explicit ``path`` (exclusively, when given) →
    ``$REPRO_TORCH_PLANNER_CALIBRATION`` → ``./planner_calibration_torch.json``.
    A missing or malformed file is never an error; an explicitly requested
    one that cannot be used is reported on stderr.  Schema 1–3 files load,
    the reference's ``planner_calibration.json`` among them.
    """
    env = os.environ.get(CALIBRATION_ENV)
    candidates = [path] if path is not None else [env,
                                                  DEFAULT_CALIBRATION_FILE]
    explicit = {c for c in (path, env) if c}
    for cand in candidates:
        if not cand:
            continue
        problem = None
        p = Path(cand)
        if not p.is_file():
            problem = "not found"
        else:
            try:
                d = json.loads(p.read_text())
            except (OSError, ValueError) as e:
                problem, d = f"unreadable ({e})", None
            if d is not None and d.get("schema") not in CALIBRATION_SCHEMAS:
                problem = (f"schema {d.get('schema')!r} not in "
                           f"{CALIBRATION_SCHEMAS}")
        if problem is not None:
            if cand in explicit:
                print(f"[planner] ignoring calibration {cand}: {problem}; "
                      f"using built-in defaults", file=sys.stderr)
                return CostModel()
            continue
        d["source"] = str(p)
        return CostModel.from_dict(d)
    return CostModel()


def persist_escalation_fraction(fraction: float,
                                path: Optional[str] = None) -> Optional[str]:
    """Fold a run's measured escalation fraction into the calibration file.

    EMA with weight 0.5 against any existing value; resolution as
    `load_calibration` (argument → env → cwd default); schema-1/2 files are
    upgraded in place keeping their other constants; I/O or parse problems
    are swallowed.  Returns the path written, or None.
    """
    frac = min(1.0, max(0.0, float(fraction)))
    target = path or os.environ.get(CALIBRATION_ENV) \
        or DEFAULT_CALIBRATION_FILE
    p = Path(target)
    d: Dict[str, Any] = {}
    if p.is_file():
        try:
            loaded = json.loads(p.read_text())
            if (isinstance(loaded, dict)
                    and loaded.get("schema") in CALIBRATION_SCHEMAS):
                d = loaded
        except (OSError, ValueError):
            pass
    prev = d.get("escalation_fraction")
    if isinstance(prev, (int, float)):
        frac = 0.5 * float(prev) + 0.5 * frac
    d["schema"] = CALIBRATION_SCHEMA
    d["escalation_fraction"] = frac
    try:
        p.write_text(json.dumps(d, indent=2, sort_keys=True) + "\n")
    except OSError:
        return None
    return str(p)


# ---------------------------------------------------------------------------
# root-block schedule
# ---------------------------------------------------------------------------

def block_degree_stat(g: DataGraph, root_block: int) -> np.ndarray:
    """Per-root-block max out-degree (block-id indexed, int64 ≥ −1)."""
    n_blocks = max(1, -(-g.n // root_block))
    deg = np.diff(g.out_indptr).astype(np.int64)
    padded = np.full(n_blocks * root_block, -1, np.int64)
    padded[: deg.shape[0]] = deg
    return padded.reshape(n_blocks, root_block).max(axis=1)


def root_block_order(g: DataGraph, root_block: int,
                     mode: str = "degree") -> np.ndarray:
    """Static permutation of root-block ids — the level's block schedule.

    ``"degree"``: blocks sorted by descending max out-degree of their
    vertices (stable, so ties keep vertex-id order) — high-yield roots run
    first and τ early exit terminates levels sooner.  ``"vertex"``: the
    identity order.
    """
    n_blocks = max(1, -(-g.n // root_block))
    if mode == "vertex" or n_blocks == 1:
        return np.arange(n_blocks, dtype=np.int64)
    if mode != "degree":
        raise ValueError('root_order must be "degree" or "vertex"')
    block_max = block_degree_stat(g, root_block)
    # stable descending sort: ties stay in ascending block-id order
    return np.argsort(-block_max, kind="stable").astype(np.int64)


# ---------------------------------------------------------------------------
# per-level plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One level's execution decision (JSON-stable via to/from_dict)."""

    plane: str                 # "sequential" | "batched" | "sampled"
    match: MatchConfig         # per-level matcher geometry
    max_batch: int             # pattern-bucket ceiling for level_groups
    # sampled plane only: the level's recorded block draw — {"fraction",
    # "n_sample", "n_requested", "positions" (schedule indices), "pis",
    # "key", "weights" ("occupancy" | "degree" | "full"), "w" (the full
    # schedule-ordered weight vector the adaptive rounds redraw from)}
    sample: Optional[Dict[str, Any]] = None
    # auto pricing record: every input of the sampled-vs-batched decision
    # ({"batched_s", "sampled_s", "replay_s", "fraction", "esc",
    # "esc_source", "margin", "tau_min", "hidden_bound", "chosen"})
    pricing: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        """The decision as recorded in per_level (JSON-native values)."""
        m = self.match
        d = {
            "plane": self.plane,
            "cap": int(m.cap),
            "root_block": int(m.root_block),
            "chunk": int(m.chunk),
            "max_chunks": int(m.max_chunks),
            "two_phase": bool(m.two_phase),
            "max_batch": int(self.max_batch),
        }
        if self.sample is not None:
            d["sample"] = self.sample
        if self.pricing is not None:
            d["pricing"] = self.pricing
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any], base: MatchConfig) -> "LevelPlan":
        """Rebuild a recorded decision on top of the run's base geometry."""
        match = dataclasses.replace(
            base,
            cap=int(d["cap"]),
            root_block=int(d["root_block"]),
            chunk=int(d["chunk"]),
            max_chunks=int(d["max_chunks"]),
            two_phase=bool(d["two_phase"]),
        )
        return cls(plane=str(d["plane"]), match=match,
                   max_batch=int(d["max_batch"]), sample=d.get("sample"),
                   pricing=d.get("pricing"))


class ExecutionPlanner:
    """Chooses (plane, bucket, geometry) per level for ``mine()``.

    Forced execution modes pass through unchanged; ``"auto"`` applies the
    cost model; ``"sampled"`` draws the level's block sample.  Pure host
    arithmetic, deterministic given (graph, config, cost model).  The port
    runs on one card (``n_devices`` 1): ``"distributed"`` is not ported.
    """

    def __init__(self, g: DataGraph, cfg, *,
                 cost_model: Optional[CostModel] = None,
                 n_devices: int = 1):
        if cfg.execution in UNPORTED_PLANES:
            raise NotImplementedError(
                f"execution={cfg.execution!r} is not ported yet: "
                f"{UNPORTED_PLANES[cfg.execution]}")
        self.g = g
        self.cfg = cfg
        self.cost = cost_model or load_calibration()
        self.n_devices = max(1, int(n_devices))
        self.block_order = root_block_order(
            g, cfg.match.root_block, getattr(cfg, "root_order", "degree"))
        self.n_blocks = int(self.block_order.shape[0])

    # -- geometry -----------------------------------------------------------
    def derive_match(self, k: int,
                     prev: Optional[Dict[str, Any]]) -> MatchConfig:
        """Per-level `MatchConfig` from observed occupancy: ``cap`` shrinks
        to pow2(max(CAP_HEADROOM · max_count, CAP_FLOOR)) after a level
        without overflow, and ``two_phase`` is dropped for k == 2."""
        base = self.cfg.match
        cap = base.cap
        if prev is not None and not prev.get("overflowed", False):
            peak = int(prev.get("max_count", 0))
            if peak > 0:
                cap = min(base.cap,
                          max(_pow2_ceil(CAP_HEADROOM * peak), CAP_FLOOR))
        two_phase = bool(base.two_phase and k >= 3)
        if cap == base.cap and two_phase == base.two_phase:
            return base
        return dataclasses.replace(base, cap=cap, two_phase=two_phase)

    # -- bucketing ----------------------------------------------------------
    def choose_bucket(self, n_patterns: int) -> int:
        """Pattern-bucket ceiling for one level: monotone in
        ``n_patterns`` and capped by ``cfg.batch_patterns``."""
        if n_patterns <= 1:
            return 1
        return int(min(_pow2_ceil(n_patterns), self.cfg.batch_patterns))

    # -- level costs --------------------------------------------------------
    def _level_costs(self, sizes: List[Tuple[int, int]], match: MatchConfig,
                     max_batch: int) -> Dict[str, float]:
        """Predicted per-block cost of one level under each plane;
        ``sizes`` = (group size, k) pairs of the level."""
        metric = self.cfg.metric
        seq = bat = 0.0
        for sz, k in sizes:
            seq += sz * self.cost.block_step_s(match, k, 1, batched=False,
                                               metric=metric)
            full, rem = divmod(sz, max_batch)
            for bucket_n in [max_batch] * full + ([rem] if rem else []):
                bat += self.cost.block_step_s(match, k,
                                              _pow2_ceil(bucket_n),
                                              batched=True, metric=metric)
        return {"sequential": seq, "batched": bat}

    # -- the decision -------------------------------------------------------
    def plan_level(self, level: int, patterns: Sequence, taus: Sequence[int],
                   prev: Optional[Dict[str, Any]] = None) -> LevelPlan:
        """Plan one level given its candidate set and last level's telemetry.

        Forced modes return the config's plane/geometry verbatim;
        ``"sampled"`` draws the level's sample; ``"auto"`` derives geometry
        from ``prev``, sizes the bucket, picks the cheaper of sequential and
        batched, and prices a sampled pass where batched wins.
        """
        cfg = self.cfg
        if cfg.execution == "sampled":
            return self._plan_sampled(level, patterns, taus, prev)
        if cfg.execution != "auto":
            return LevelPlan(plane=cfg.execution, match=cfg.match,
                             max_batch=cfg.batch_patterns)
        if not patterns or cfg.metric == "mis_exact":
            return LevelPlan(plane="sequential",
                             match=self.derive_match(
                                 max((p.k for p in patterns), default=2),
                                 prev),
                             max_batch=cfg.batch_patterns)

        match = self.derive_match(max(p.k for p in patterns), prev)
        # same-k group sizes, mirroring batched.level_groups' slicing
        by_k: Dict[int, int] = {}
        for p in patterns:
            by_k[p.k] = by_k.get(p.k, 0) + 1
        max_batch = self.choose_bucket(max(by_k.values()))
        sizes = sorted(by_k.items())
        costs = self._level_costs([(sz, k) for k, sz in sizes], match,
                                  max_batch)

        plane = "sequential" if costs["sequential"] <= costs["batched"] \
            else "batched"
        if plane == "batched":
            sample, pricing = self._price_sampled(
                level, taus, prev, match,
                [(sz, k) for k, sz in sizes], max_batch, costs["batched"])
            if pricing is not None and pricing["chosen"] == "sampled":
                return LevelPlan(plane="sampled", match=match,
                                 max_batch=max_batch, sample=sample,
                                 pricing=pricing)
            if pricing is not None:
                return LevelPlan(plane="batched", match=match,
                                 max_batch=max_batch, pricing=pricing)
        return LevelPlan(plane=plane, match=match, max_batch=max_batch)

    # -- auto sampled pricing -----------------------------------------------
    def _predict_escalation(self, prev: Optional[Dict[str, Any]]
                            ) -> Tuple[float, str]:
        """Predicted escalation mass for the next level's sample:
        ``"telemetry"`` (the previous level ran sampled) → ``"frontier"``
        (its frequent/searched ratio) → ``"prior"`` (`CostModel.esc_prior`).
        """
        prior = self.cost.esc_prior()
        if prev is not None:
            s = prev.get("sampled")
            if s is not None and not s.get("exact", False):
                classified = int(s.get("escalated", 0)) + int(
                    s.get("pruned", 0))
                if classified > 0:
                    return (int(s.get("escalated", 0)) / classified,
                            "telemetry")
            searched = int(prev.get("searched", 0))
            if searched > 0:
                freq = min(1.0, int(prev.get("frequent", 0)) / searched)
                return min(1.0, freq + prior * (1.0 - freq)), "frontier"
        return prior, "prior"

    def _price_sampled(self, level: int, taus: Sequence[int],
                       prev: Optional[Dict[str, Any]], match: MatchConfig,
                       sizes: List[Tuple[int, int]], max_batch: int,
                       batched_s: float
                       ) -> Tuple[Optional[Dict[str, Any]],
                                  Optional[Dict[str, Any]]]:
        """Price a sampled pass for one auto level; returns (sample, pricing).

        (None, None) when the level is ineligible.  The sampled row is
        ``f·batched + E[esc]·((1−f)·batched + f·replay)``; sampled wins only
        under `SAMPLED_MARGIN` and above the hidden-mass bound.
        """
        cfg = self.cfg
        m = self.n_blocks
        if (cfg.metric not in _BATCHABLE_METRICS or cfg.complete
                or not getattr(cfg, "escalate", True)
                or m < MIN_SAMPLED_BLOCKS or not taus):
            return None, None
        f = min(1.0, max(1, math.ceil(cfg.sample_fraction * m)) / m)
        if f >= 1.0:
            return None, None
        hidden = hidden_mass_bound(cfg.confidence, f)
        tau_min = int(min(taus))
        esc, esc_source = self._predict_escalation(prev)
        rep = 0.0
        for sz, k in sizes:
            full, r = divmod(sz, max_batch)
            for bucket_n in [max_batch] * full + ([r] if r else []):
                rep += self.cost.replay_step_s(match, k,
                                               _pow2_ceil(bucket_n),
                                               metric=cfg.metric)
        # per root block, like `_level_costs`: the sample pass runs f of the
        # blocks, escalation matches the unsampled (1−f) and replays f
        sampled_s = batched_s * f \
            + esc * (batched_s * (1.0 - f) + rep * f)
        pricing = {
            "batched_s": float(batched_s), "sampled_s": float(sampled_s),
            "replay_s": float(rep), "fraction": float(f),
            "esc": float(esc), "esc_source": esc_source,
            "margin": SAMPLED_MARGIN, "tau_min": tau_min,
            "hidden_bound": float(hidden),
        }
        if tau_min <= hidden or sampled_s >= SAMPLED_MARGIN * batched_s:
            pricing["chosen"] = "batched"
            return None, pricing
        sample = self._draw_block_sample(level, prev, match,
                                         cfg.sample_fraction)
        pricing["chosen"] = "sampled"
        return sample, pricing

    # -- sampled plane ------------------------------------------------------
    def _plan_sampled(self, level: int, patterns: Sequence,
                      taus: Sequence[int],
                      prev: Optional[Dict[str, Any]]) -> LevelPlan:
        """Draw (and record) one level's root-block sample.

        Keeps the config's geometry and bucket; degenerate levels (empty,
        ``complete``, fewer than `MIN_SAMPLED_BLOCKS` blocks) plan the exact
        batched plane; a fraction that rounds up to full coverage keeps the
        sampled plane with a unit-probability sample.
        """
        from . import sampled as sampled_lib

        cfg = self.cfg
        match, max_batch = cfg.match, cfg.batch_patterns
        m = self.n_blocks
        if not patterns or cfg.complete or m < MIN_SAMPLED_BLOCKS:
            return LevelPlan(plane="batched", match=match,
                             max_batch=max_batch)

        key = sampled_lib.sample_key(cfg.sample_seed, level)
        n_sample = max(1, math.ceil(cfg.sample_fraction * m))
        by_k: Dict[int, int] = {}
        for p in patterns:
            by_k[p.k] = by_k.get(p.k, 0) + 1
        costs = self._level_costs([(sz, k) for k, sz in sorted(by_k.items())],
                                  match, self.choose_bucket(max(by_k.values())))
        f = n_sample / m
        sampled_cost = costs["batched"] * (f + self.cost.esc_prior()
                                           * (1.0 - f))
        if sampled_cost > costs["batched"]:
            return LevelPlan(plane="batched", match=match,
                             max_batch=max_batch)
        if n_sample >= m:
            sample = {"fraction": 1.0, "n_sample": int(m),
                      "n_requested": int(m),
                      "positions": list(range(m)), "pis": [1.0] * m,
                      "key": key, "weights": "full", "w": [1.0] * m}
            return LevelPlan(plane="sampled", match=match,
                             max_batch=max_batch, sample=sample)
        sample = self._draw_block_sample(level, prev, match,
                                         cfg.sample_fraction)
        return LevelPlan(plane="sampled", match=match, max_batch=max_batch,
                         sample=sample)

    def _draw_block_sample(self, level: int, prev: Optional[Dict[str, Any]],
                           match: MatchConfig,
                           fraction: float) -> Dict[str, Any]:
        """One level's recorded systematic-PPS block draw (round 0).

        Weights: the previous level's per-block peak occupancy
        (``prev["block_peaks"]``, block-id indexed, re-ordered by the
        schedule), else the degree stat; floored at 1 so every block keeps
        a nonzero inclusion probability.
        """
        from . import sampled as sampled_lib

        cfg = self.cfg
        m = self.n_blocks
        key = sampled_lib.sample_key(cfg.sample_seed, level)
        n_sample = min(m, max(1, math.ceil(fraction * m)))
        peaks = None if prev is None else prev.get("block_peaks")
        if peaks is not None and len(peaks) == m:
            w = np.asarray(peaks, np.float64)[self.block_order]
            weights_src = "occupancy"
        else:
            w = block_degree_stat(
                self.g, match.root_block).astype(np.float64)[self.block_order]
            weights_src = "degree"
        w = np.maximum(w, 1.0)
        u = sampled_lib.sample_uniform(key)
        positions, pis = sampled_lib.systematic_sample(w, n_sample, u)
        return {
            "fraction": float(fraction),
            "n_sample": int(positions.shape[0]),
            "n_requested": int(n_sample),
            "positions": [int(x) for x in positions],
            "pis": [float(x) for x in pis],
            "key": key,
            "weights": weights_src,
            "w": [float(x) for x in w],
        }
