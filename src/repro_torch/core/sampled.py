"""Sampled data plane — bounded-error support estimation with exact escalation.

FLEXIS's τ early exit makes every answer exact but still pays full
root-block coverage for *infrequent* patterns (they never cross τ, so they
run every block).  FS³-style sampling inverts that cost: run each
candidate over a weighted sample of root blocks, extrapolate its support
with a Horvitz–Thompson-style estimator, and only spend full coverage on
patterns whose confidence interval cannot rule τ in or out.

The plane's contract (``execution="sampled"``, ``escalate=True``):

  * **sample pass** — the planner draws ``n_sample`` schedule positions
    without replacement (systematic PPS: inclusion probabilities exactly
    ``min(1, s·p_i)``), weighted by the previous level's per-block frontier
    occupancy (``block_peaks`` telemetry) with degree-ordered fallback
    weights at k = 2.  The pass runs `_mine_group` in *complete* mode over
    the sampled blocks only, recording each pattern's per-block support
    increments;
  * **classify** — per pattern, a HT estimate plus a normal-approximation
    confidence interval from the increment variance.  Patterns whose whole
    interval sits below τ are *pruned*: reported infrequent with an
    ``estimated=True`` outcome (support clamped to τ−1).  Everything else
    — interval straddling τ or above it — **escalates**;
  * **escalate** — the escalated subset re-runs on the exact batched plane
    from block 0 over the full schedule with real τ early exit.  Because
    per-pattern batched results are bucket-composition-independent (the
    batched ≡ sequential contract), every escalated pattern's outcome is
    bit-identical to the forced-batched oracle's — so the frequent set,
    its supports, and the whole level trajectory match the oracle exactly;
    only pruned (truly infrequent) patterns carry estimates.

Fraction 1.0 (or ``complete=True``) degenerates to the exact batched plane
over the full schedule — zero escalations, bit-identical everything.

Statistical machinery (`normal_quantile`, `systematic_sample`,
`ht_interval`) is pure and host-side; the RNG chain is counter-based
(Philox keyed on ``(sample_seed, level)``), recorded in the level plan and
replayed verbatim on resume, so a killed run re-draws the identical sample.
The port keeps the reference's statistics verbatim (numpy only), so both
packages draw the same samples from the same keys; its sample pass records
each (pattern, block)'s embedding rows as int32 arrays copied from the card
once per block.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batched import (
    DEFAULT_MAX_BATCH, LevelTelemetry, PatternOutcome, _bucket_size,
    _mine_group, _state_bytes, evaluate_level_batched, level_groups,
)
from .graph import DataGraph, DeviceGraph
from .matcher import MatchConfig, transient_match_bytes
from .pattern import Pattern
from .plan import make_plan

__all__ = [
    "evaluate_level_sampled", "ht_estimate", "ht_interval",
    "inclusion_probs", "normal_quantile", "sample_key", "sample_uniform",
    "systematic_sample",
]

# near-certain inclusion: treat π within fp-noise of 1 as a certainty unit
_CERTAIN = 1.0 - 1e-9


# ---------------------------------------------------------------------------
# pure statistical machinery
# ---------------------------------------------------------------------------

def normal_quantile(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    |error| < 1.2e-9 over (0, 1) — far below the CI slack the escalation
    rule tolerates — with no scipy dependency.
    """
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0, 1)")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p_low, p_high = 0.02425, 1 - 0.02425
    if p < p_low:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > p_high:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                 + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q
                            + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


def sample_key(seed: int, level: int) -> List[int]:
    """The level's RNG key — explicit, recorded, replayed on resume."""
    return [int(seed), int(level)]


def sample_uniform(key: Sequence[int], count: int = 1) -> float:
    """The ``count``-th uniform in [0, 1) from a counter-based (Philox) key.

    Counter-based so the draw depends only on the key words — identical
    across platforms, processes, and resumes.  ``count`` indexes into the
    key's stream (1 = the first value, the default): adaptive round ``r``
    consumes the ``(r+1)``-th value, so every round's uniform is a pure
    function of (key, round) and replays verbatim.
    """
    if count < 1:
        raise ValueError("count must be >= 1")
    words = [int(k) & 0xFFFFFFFFFFFFFFFF for k in key]
    # Philox takes exactly two 64-bit key words; fold the domain tag
    # ("SP", sample plane) into the first so other users of the same seed
    # space draw from a disjoint stream
    words[0] ^= 0x5350 << 40
    gen = np.random.Generator(
        np.random.Philox(key=np.asarray(words[:2], np.uint64)))
    return float(gen.random(count)[-1])


def systematic_sample(weights: np.ndarray, n_sample: int,
                      u: float) -> Tuple[np.ndarray, np.ndarray]:
    """Without-replacement PPS sample of ``n_sample`` of ``m`` units.

    Systematic (Madow) selection driven by the single uniform ``u``, with
    iterative certainty-unit extraction so inclusion probabilities are
    *exactly* ``π_i = min(1, s·p_i)`` — which is what makes the HT
    estimator in `ht_interval` unbiased.

    Returns (positions, pis): selected unit indices in ascending order and
    their inclusion probabilities.
    """
    w = np.asarray(weights, np.float64)
    if np.any(w < 0) or not np.all(np.isfinite(w)):
        raise ValueError("weights must be finite and non-negative")
    m = int(w.shape[0])
    s = int(min(n_sample, m))
    if s <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    if s >= m:
        return np.arange(m, dtype=np.int64), np.ones(m, np.float64)
    w = np.maximum(w, 1e-12)          # every unit must be reachable

    certain = np.zeros(m, bool)
    while True:                       # extract units with s_r·p_i ≥ 1
        s_r = s - int(certain.sum())
        if s_r <= 0:
            break
        rest = ~certain
        p = s_r * w / max(w[rest].sum(), 1e-300)
        newly = rest & (p >= 1.0)
        if not newly.any():
            break
        certain |= newly

    pis = np.zeros(m, np.float64)
    pis[certain] = 1.0
    selected = certain.copy()
    rest_idx = np.flatnonzero(~certain)
    s_r = s - int(certain.sum())
    if s_r > 0:
        p = s_r * w[rest_idx] / w[rest_idx].sum()     # all < 1 by the loop
        pis[rest_idx] = p
        cum = np.cumsum(p)
        cum[-1] = float(s_r)                          # fp guard
        picks = np.searchsorted(cum, u + np.arange(s_r), side="right")
        picks = np.unique(np.clip(picks, 0, rest_idx.size - 1))
        selected[rest_idx[picks]] = True
    positions = np.flatnonzero(selected).astype(np.int64)
    return positions, pis[positions]


def inclusion_probs(weights: np.ndarray, n_sample: int) -> np.ndarray:
    """Full inclusion-probability vector of `systematic_sample`'s design.

    Systematic PPS inclusion probabilities are a pure function of
    (weights, n_sample) — the uniform only picks *which* units land in the
    sample, not how likely each was.  Mirrors `systematic_sample`'s
    certainty-extraction loop exactly, so
    ``inclusion_probs(w, s)[positions] == pis`` for any draw.  The
    adaptive sampler needs the probabilities of the *undrawn* units too:
    conditional PPS composes round-r draw probabilities onto the
    cumulative inclusion probability of every still-undrawn unit.
    """
    w = np.asarray(weights, np.float64)
    if np.any(w < 0) or not np.all(np.isfinite(w)):
        raise ValueError("weights must be finite and non-negative")
    m = int(w.shape[0])
    s = int(min(n_sample, m))
    if s <= 0:
        return np.zeros(m, np.float64)
    if s >= m:
        return np.ones(m, np.float64)
    w = np.maximum(w, 1e-12)

    certain = np.zeros(m, bool)
    while True:
        s_r = s - int(certain.sum())
        if s_r <= 0:
            break
        rest = ~certain
        p = s_r * w / max(w[rest].sum(), 1e-300)
        newly = rest & (p >= 1.0)
        if not newly.any():
            break
        certain |= newly

    pis = np.zeros(m, np.float64)
    pis[certain] = 1.0
    rest_idx = np.flatnonzero(~certain)
    s_r = s - int(certain.sum())
    if s_r > 0:
        pis[rest_idx] = s_r * w[rest_idx] / w[rest_idx].sum()
    return pis


def ht_estimate(ys: np.ndarray, pis: np.ndarray) -> float:
    """Horvitz–Thompson total: Σ y_i / π_i over the sampled units."""
    ys = np.asarray(ys, np.float64)
    pis = np.asarray(pis, np.float64)
    return float(np.sum(ys / np.maximum(pis, 1e-300)))


def ht_interval(ys: np.ndarray, pis: np.ndarray, n_total: int,
                confidence: float) -> Tuple[float, float, float]:
    """(estimate, lo, hi): HT total plus a small-sample-hardened CI.

    Certainty units (π = 1) contribute exactly; the variance comes from
    the non-certainty draws via the PPS-with-replacement approximation
    — ``Var ≈ Var(t_i) / s_r`` with ``t_i = y_i / p_i`` — which
    needs ≥ 2 such draws; with fewer the interval is (−∞, +∞), which the
    escalation rule reads as "cannot prune, go exact".

    Two deliberate asymmetries harden the *upper* bound — the one the
    escalation rule prunes on, where an optimistic error loses a frequent
    pattern instead of wasting a block:

      * the normal quantile is inflated toward Student's t with
        ``s_r − 1`` degrees of freedom (Cornish–Fisher one-term
        expansion) — at 4 draws the nominal-95% z of 1.96 is closer to 3;
      * ``hi`` additionally carries the largest observed single-unit HT
        contribution ``max y_i/π_i`` — "one more block as heavy as the
        heaviest seen" — so a support concentrated in few blocks cannot
        be pruned off one lucky-low draw;
      * a pattern with **zero observed mass** gets the hidden-block bound
        instead of the (degenerate, zero-width) normal CI: if ``h`` blocks
        each carried ≥ 1 embedding, a coverage-``f`` draw misses all of
        them with probability ≲ ``(1−f)^h``, so at confidence ``1−α`` the
        support may still be as large as ``ln α / ln(1−f)`` — e.g. ≈ 10 at
        f = 0.25, ≈ 4 at f = 0.5.  Zero-mass patterns therefore only prune
        against a τ above that bound, which is exactly the regime (real σ,
        deep levels) where the sampled plane earns its keep.

    ``lo`` is clipped at 0 (supports are non-negative).
    """
    ys = np.asarray(ys, np.float64)
    pis = np.asarray(pis, np.float64)
    est = ht_estimate(ys, pis)
    rest = pis < _CERTAIN
    s_r = int(rest.sum())
    if s_r < 2:
        if s_r == 0:                    # full coverage — exact
            return est, est, est
        return est, -math.inf, math.inf
    f_cov = ys.shape[0] / max(n_total, 1)
    if not np.any(ys > 0):
        hidden = math.log(max(1.0 - confidence, 1e-300)) \
            / math.log(max(1.0 - f_cov, 1e-300))
        return 0.0, 0.0, hidden
    t = ys[rest] * s_r / pis[rest]      # y_i / p_i  (π_i = s_r · p_i)
    # deliberately NO finite-population correction: the with-replacement
    # variance over-covers at high fractions, and over-coverage only costs
    # an escalation (exact, cheap) where under-coverage costs correctness
    var = float(np.var(t, ddof=1)) / s_r
    z = normal_quantile(0.5 + confidence / 2.0)
    z += (z ** 3 + z) / (4.0 * (s_r - 1))          # ≈ t-quantile, df = s_r−1
    half = z * math.sqrt(max(var, 0.0))
    guard = float(np.max(ys[rest] / np.maximum(pis[rest], 1e-300)))
    return est, max(0.0, est - half), est + half + guard


# ---------------------------------------------------------------------------
# sample pass (one same-k group over the sampled schedule)
# ---------------------------------------------------------------------------

def sample_group(
    dev_g: DeviceGraph,
    plans: List,
    group_taus: Sequence[int],
    metric: str,
    cfg: MatchConfig,
    *,
    n: int,
    sampled_ids: np.ndarray,
    deadline: Optional[float] = None,
    schedule_positions: Optional[np.ndarray] = None,
    record_embeddings: bool = False,
):
    """Complete-mode `_mine_group` over the sampled blocks only.

    Returns (ys, outs, dispatches, block_peaks, timed_out, replay) where
    ``ys`` is the (P₀, s) matrix of per-sampled-block support increments —
    the HT estimator's input.  Increments are non-negative for every
    batchable metric (mis/mis_luby counters, MNI minima and fractional
    mass are all monotone non-decreasing in blocks processed).

    With ``record_embeddings=True`` the steps run in capture mode and
    ``replay`` holds, per pattern, {schedule position (str) →
    {"emb" ((c, k) int32 array: the block's valid `match_block` rows),
    "found", "ovf", "peak"}} — what lets exact escalation *replay* these
    blocks instead of re-matching them (``schedule_positions`` maps the
    subset loop index back to the level schedule).
    """
    hist: List[np.ndarray] = []

    def on_block(gs):
        hist.append(np.asarray(gs.supports, np.int64).copy())

    emb_sink = None
    replay: Optional[List[Dict[str, Any]]] = None
    if record_embeddings:
        assert schedule_positions is not None
        spos = np.asarray(schedule_positions, np.int64)
        replay = [dict() for _ in plans]

        def emb_sink(b, rows, nv, found, ovf, peak, bucket_map):
            pos = str(int(spos[b]))
            for row in range(int(bucket_map.size)):
                gi = int(bucket_map[row])
                if gi < 0:
                    continue
                replay[gi][pos] = {
                    "emb": rows[row],
                    "found": int(found[row]),
                    "ovf": bool(ovf[row]),
                    "peak": int(peak[row]),
                }

    outs, timed_out, dispatches, bpeaks, _ = _mine_group(
        dev_g, plans, list(group_taus), metric, cfg, complete=True, n=n,
        deadline=deadline, on_block=on_block, block_order=sampled_ids,
        emb_sink=emb_sink)
    if timed_out:
        return None, outs, dispatches, bpeaks, True, None
    finals = np.asarray([o.support for o in outs], np.int64)
    cum = (np.stack(hist + [finals], axis=1) if hist
           else finals[:, None])                       # (P₀, s) cumulative
    ys = np.diff(cum, axis=1, prepend=0)               # per-block increments
    return ys, outs, dispatches, bpeaks, False, replay


# ---------------------------------------------------------------------------
# hooks adapter: escalation groups live in the level recorder's normal
# group surface, but index the escalated *subset* — translate both ways
# ---------------------------------------------------------------------------

class _EscalationHooks:
    def __init__(self, hooks, esc_idx: List[int]):
        self._h = hooks
        self._to_level = list(esc_idx)
        self._to_local = {i: j for j, i in enumerate(esc_idx)}

    def resume_outcomes(self):
        ro = self._h.resume_outcomes()
        if not ro:
            return None
        return {self._to_local[i]: o for i, o in ro.items()
                if i in self._to_local}

    def resume_dispatches(self) -> int:
        return self._h.resume_dispatches()

    def resume_block_peaks(self):
        fn = getattr(self._h, "resume_block_peaks", None)
        return fn() if fn is not None else None

    def group_resume(self, k: int, lo: int):
        return self._h.group_resume(k, lo)

    def on_group_state(self, k: int, lo: int, state) -> None:
        self._h.on_group_state(k, lo, state)

    def resume_replans(self) -> int:
        fn = getattr(self._h, "resume_replans", None)
        return fn() if fn is not None else 0

    def on_group_done(self, k, lo, idxs, outcomes, dispatches,
                      block_peaks=None, replans=0) -> None:
        self._h.on_group_done(k, lo, [self._to_level[i] for i in idxs],
                              outcomes, dispatches, block_peaks=block_peaks,
                              replans=replans)


# ---------------------------------------------------------------------------
# level executor
# ---------------------------------------------------------------------------

def _estimated_outcome(est: float, tau: int, out: PatternOutcome, s: int,
                       *, pruned: bool) -> PatternOutcome:
    """An ``estimated=True`` outcome from the sample pass.

    ``pruned=True`` (escalation enabled, interval below τ): infrequent by
    contract, support clamped to τ−1 so the flag and the value agree.
    ``pruned=False`` (escalation disabled): the raw floor estimate decides
    frequency.  ``embeddings_found``/``max_count`` are the *sampled*
    observations, not extrapolations.
    """
    sup = int(math.floor(est))
    if pruned:
        sup = max(0, min(sup, tau - 1))
    return PatternOutcome(
        support=sup, frequent=bool(sup >= tau),
        embeddings_found=out.embeddings_found, overflowed=out.overflowed,
        blocks_run=s, max_count=out.max_count, estimated=True)


def _outcome_dict(o: PatternOutcome) -> Dict[str, Any]:
    return {
        "support": int(o.support), "frequent": bool(o.frequent),
        "embeddings_found": int(o.embeddings_found),
        "overflowed": bool(o.overflowed), "blocks_run": int(o.blocks_run),
        "max_count": int(o.max_count), "estimated": bool(o.estimated),
    }


def evaluate_level_sampled(
    host_g: DataGraph,
    dev_g: DeviceGraph,
    patterns: Sequence[Pattern],
    taus: Sequence[int],
    metric: str,
    cfg: MatchConfig,
    *,
    sample: Optional[Dict[str, Any]],
    confidence: float = 0.95,
    escalate: bool = True,
    complete: bool = False,
    deadline: Optional[float] = None,
    max_batch: int = DEFAULT_MAX_BATCH,
    hooks=None,
    block_order: Optional[np.ndarray] = None,
    sample_rounds: int = 1,
    counters: Optional[Dict[str, int]] = None,
) -> Tuple[List[Optional[PatternOutcome]], bool, LevelTelemetry]:
    """Evaluate a candidate level with the sampled plane (module docstring).

    ``sample`` is the planner's recorded draw (`LevelPlan.sample`):
    ``{"positions", "pis", "key", "w", ...}`` with positions indexing the
    schedule ``block_order``.  ``None`` — or full coverage, or
    ``complete=True`` — degenerates to the exact batched plane.

    **Adaptive rounds** (``sample_rounds`` > 1): after classifying the
    plan's round-0 draw, still-undecided patterns get further geometric
    rounds — each doubles coverage by drawing ``min(|undrawn|, |drawn|)``
    new blocks from the complement via conditional PPS.  A drawn unit's
    estimator π is *frozen* at its cumulative inclusion probability at
    draw time (round r composes ``π' = π + (1−π)·q_r`` onto every
    complement unit); freezing understates the true multi-round inclusion,
    so the HT total only over-estimates — escalating more, never pruning a
    frequent pattern.  Rounds stop when the undecided set stops shrinking,
    empties, coverage completes, or ``sample_rounds`` is reached.  Round
    draws are pure functions of (key, round, weights, drawn-set) and each
    round is recorded in the phase cursor, so killed sessions resume
    mid-round bit-identically.

    **Escalation reuse** (``escalate=True``): the sample pass runs in
    capture mode, recording each (pattern, block) raw match result; the
    exact escalation then walks the full schedule but *replays* sampled
    positions with the cheap update-only step instead of re-matching them
    (`evaluate_level_batched`'s ``replay``).  ``counters`` threads through
    to the escalation pass only — ``{"match_blocks", "replay_blocks"}``
    counts prove no sampled block is ever re-matched.  On the card the
    replayed ``"mis"`` update is the mis_bitmap kernel fed from the
    recorded rows.

    ``hooks`` extends the batched resume surface (a session runtime's) with the sampled-phase
    cursor: ``resume_sampled()`` → the recorded phase dict or None, and
    ``on_sampled(dict)`` — called after every completed sample group and
    once more when classification lands, each a snapshot point.  The
    escalation phase reuses the *group* surface (``group_resume`` /
    ``on_group_state`` / ``on_group_done``) verbatim, with outcome indices
    mapped back to level positions.
    """
    assert len(patterns) == len(taus)
    n = host_g.n
    total_blocks = -(-n // cfg.root_block)
    if block_order is None:
        block_order = np.arange(total_blocks, dtype=np.int64)
    m = int(block_order.shape[0])

    if sample is None:
        positions = np.arange(m, dtype=np.int64)
        pis = np.ones(m, np.float64)
    else:
        positions = np.asarray(sample["positions"], np.int64)
        pis = np.asarray(sample["pis"], np.float64)
    s = int(positions.shape[0])

    if complete or s >= m:
        # full coverage: the exact batched plane IS the sampled plane at
        # fraction 1.0 — real τ early exit, zero escalations
        outcomes, timed_out, tel = evaluate_level_batched(
            host_g, dev_g, patterns, taus, metric, cfg, complete=complete,
            deadline=deadline, max_batch=max_batch, hooks=hooks,
            block_order=block_order)
        tel.sampled = {
            "fraction": 1.0, "n_sample": m, "n_blocks": m, "rounds": 0,
            "escalated": 0, "pruned": 0, "exact": True,
            "confidence": float(confidence), "ci_width_mean": 0.0,
        }
        return outcomes, timed_out, tel

    P = len(patterns)
    w = np.maximum(np.asarray(sample.get("w", np.ones(m)), np.float64),
                   1e-12)
    key = list(sample.get("key", []))
    telemetry = LevelTelemetry()
    peaks = np.zeros(total_blocks, np.int64)
    outcomes: List[Optional[PatternOutcome]] = [None] * P

    rec = None
    if hooks is not None:
        fn = getattr(hooks, "resume_sampled", None)
        rec = fn() if fn is not None else None
    sgroups: Dict[str, Dict[str, Any]] = dict(rec["groups"]) if rec else {}
    classify: Optional[Dict[str, Any]] = rec.get("classify") if rec else None
    rec_rounds: List[Dict[str, Any]] = list((rec or {}).get("rounds") or [])
    rounds: List[Dict[str, Any]] = []

    def record(phase: str) -> None:
        if hooks is None:
            return
        fn = getattr(hooks, "on_sampled", None)
        if fn is not None:
            fn({"phase": phase, "positions": [int(p) for p in positions],
                "key": key, "rounds": rounds, "groups": sgroups,
                "classify": classify})

    # cumulative inclusion state after the plan's round-0 draw.  The
    # frozen per-unit π of round 0 are the plan's exact `pis`;
    # `inclusion_probs` gives the matching full-schedule vector (the
    # requested draw size, not the post-clip count, parameterises the
    # design — `n_requested`).
    drawn = np.zeros(m, bool)
    drawn[positions] = True
    pi_cum = inclusion_probs(w, int(sample.get("n_requested", s)))

    ys_acc: Dict[int, List[float]] = {i: [] for i in range(P)}
    pis_acc: Dict[int, List[float]] = {i: [] for i in range(P)}
    outs_acc: Dict[int, Dict[str, Any]] = {}
    replay_tab: Dict[int, Dict[int, Any]] = {i: {} for i in range(P)}
    width_of: Dict[int, float] = {}
    pruned: Dict[str, Dict[str, Any]] = {}
    undecided: List[int] = list(range(P))
    max_rounds = max(1, int(sample_rounds))
    n_rounds_run = 0
    timed_out = False

    # -- phases 1+2: sample rounds + classification -------------------------
    if classify is not None:
        # resumed past classification: rebuild the drawn set and the
        # escalation replay table from the recorded rounds/groups
        rounds = rec_rounds
        n_rounds_run = int(classify.get("rounds", 1 + len(rec_rounds)))
        for rr in rec_rounds:
            drawn[np.asarray(rr["positions"], np.int64)] = True
        for g in sgroups.values():
            rep = g.get("replay")
            if rep is not None:
                for j, i in enumerate(g["idxs"]):
                    replay_tab[int(i)].update(
                        {int(p): v for p, v in rep[j].items()})
    else:
        r = 0
        while True:
            # this round's draw: plan (r = 0), recorded (resume), or live
            if r == 0:
                r_pos, r_pis = positions, pis
            elif r <= len(rec_rounds):
                rr = rec_rounds[r - 1]
                comp = np.flatnonzero(~drawn)
                r_pos = np.asarray(rr["positions"], np.int64)
                r_pis = np.asarray(rr["pis"], np.float64)
                pi_cum[comp] += (1.0 - pi_cum[comp]) \
                    * inclusion_probs(w[comp], int(rr["n_new"]))
                drawn[r_pos] = True
                rounds.append(dict(rr))
            else:
                comp = np.flatnonzero(~drawn)
                n_new = int(min(comp.size, drawn.sum()))
                if n_new <= 0:
                    break
                u_r = sample_uniform(key, count=r + 1)
                pos_local, pis_local = systematic_sample(w[comp], n_new, u_r)
                r_pos = comp[pos_local]
                # freeze the estimator π at draw time: composed cumulative
                # inclusion, conditional on not being drawn earlier
                r_pis = pi_cum[r_pos] + (1.0 - pi_cum[r_pos]) * pis_local
                pi_cum[comp] += (1.0 - pi_cum[comp]) \
                    * inclusion_probs(w[comp], n_new)
                drawn[r_pos] = True
                rounds.append({
                    "round": int(r), "n_new": int(n_new),
                    "positions": [int(x) for x in r_pos],
                    "pis": [float(x) for x in r_pis],
                })

            # run the round over the still-undecided patterns
            und = sorted(undecided)
            sub_groups = list(level_groups([patterns[i] for i in und],
                                           max_batch))
            sampled_ids_r = block_order[r_pos]
            for k, lo, jdxs in sub_groups:
                idxs = [und[j] for j in jdxs]
                gk = f"{k}:{lo}:r{r}"
                if gk in sgroups:
                    continue
                if deadline is not None and time.monotonic() > deadline:
                    timed_out = True
                    break
                plans = [make_plan(patterns[i], host_g) for i in idxs]
                ys, outs, disp, bpeaks, g_timed, rep = sample_group(
                    dev_g, plans, [taus[i] for i in idxs], metric, cfg, n=n,
                    sampled_ids=sampled_ids_r, deadline=deadline,
                    schedule_positions=r_pos, record_embeddings=escalate)
                if g_timed:
                    timed_out = True
                    break
                sgroups[gk] = {
                    "idxs": [int(i) for i in idxs],
                    "ys": ys.tolist(),
                    "outs": [_outcome_dict(o) for o in outs],
                    "dispatches": int(disp),
                    "block_peaks": [int(x) for x in bpeaks],
                    **({"replay": rep} if rep is not None else {}),
                }
                record("sample")
            if timed_out:
                break

            # merge the round into the per-pattern accumulators
            for k, lo, jdxs in sub_groups:
                g = sgroups[f"{k}:{lo}:r{r}"]
                ys_g = np.asarray(g["ys"], np.float64)
                rep = g.get("replay")
                for j, i in enumerate(g["idxs"]):
                    i = int(i)
                    ys_acc[i].extend(float(x) for x in ys_g[j])
                    pis_acc[i].extend(float(x) for x in r_pis)
                    od = dict(g["outs"][j])
                    prev_od = outs_acc.get(i)
                    if prev_od is not None:
                        od["embeddings_found"] += prev_od["embeddings_found"]
                        od["overflowed"] = (od["overflowed"]
                                            or prev_od["overflowed"])
                        od["max_count"] = max(od["max_count"],
                                              prev_od["max_count"])
                    outs_acc[i] = od
                    if rep is not None:
                        replay_tab[i].update(
                            {int(p): v for p, v in rep[j].items()})

            # classify: prune what the cumulative interval settles
            newly_pruned = 0
            still: List[int] = []
            for i in und:
                ys_i = np.asarray(ys_acc[i], np.float64)
                pis_i = np.asarray(pis_acc[i], np.float64)
                est, lo_ci, hi_ci = ht_interval(ys_i, pis_i, m, confidence)
                out = PatternOutcome(**outs_acc[i])
                s_i = int(ys_i.shape[0])
                if not escalate:
                    pruned[str(i)] = _outcome_dict(_estimated_outcome(
                        est, taus[i], out, s_i, pruned=False))
                elif hi_ci < taus[i]:
                    pruned[str(i)] = _outcome_dict(_estimated_outcome(
                        est, taus[i], out, s_i, pruned=True))
                else:
                    still.append(i)
                    continue
                if math.isfinite(hi_ci - lo_ci):
                    width_of[i] = float(hi_ci - lo_ci)
                newly_pruned += 1
            undecided = still
            n_rounds_run = r + 1
            if (not undecided or not escalate or newly_pruned == 0
                    or bool(drawn.all()) or n_rounds_run >= max_rounds):
                break
            r += 1

        if not timed_out:
            classify = {
                "escalate": [int(i) for i in undecided], "pruned": pruned,
                "rounds": int(n_rounds_run),
                # the settled-set mean is None — not NaN, not 0.0 — when
                # every pattern escalated
                "ci_width_mean": (float(np.mean(list(width_of.values())))
                                  if width_of else None),
            }
            record("escalate")

    telemetry.dispatches += sum(g["dispatches"] for g in sgroups.values())
    for gk, g in sgroups.items():
        peaks = np.maximum(peaks, np.asarray(g["block_peaks"], np.int64))
        telemetry.state_bytes = max(
            telemetry.state_bytes,
            _bucket_size(len(g["idxs"]))
            * (_state_bytes(metric, int(gk.split(":")[0]), n)
               + transient_match_bytes(cfg, int(gk.split(":")[0]))))
    if timed_out:
        telemetry.block_peaks = peaks
        return outcomes, True, telemetry

    esc_idx = [int(i) for i in classify["escalate"]]
    for i_str, od in classify["pruned"].items():
        outcomes[int(i_str)] = PatternOutcome(**od)

    # -- phase 3: exact escalation (replaying every sampled block) ----------
    if esc_idx:
        adapter = _EscalationHooks(hooks, esc_idx) if hooks is not None \
            else None
        replay_list = None
        if all(replay_tab.get(i) for i in esc_idx):
            replay_list = [{int(p): v for p, v in replay_tab[i].items()}
                           for i in esc_idx]
        outs2, esc_timed, tel2 = evaluate_level_batched(
            host_g, dev_g, [patterns[i] for i in esc_idx],
            [taus[i] for i in esc_idx], metric, cfg, complete=complete,
            deadline=deadline, max_batch=max_batch, hooks=adapter,
            block_order=block_order, replay=replay_list, counters=counters)
        timed_out |= esc_timed
        for i, o in zip(esc_idx, outs2):
            outcomes[i] = o
        telemetry.dispatches += tel2.dispatches
        telemetry.state_bytes = max(telemetry.state_bytes, tel2.state_bytes)
        if tel2.block_peaks is not None:
            peaks = np.maximum(peaks, tel2.block_peaks)

    telemetry.block_peaks = peaks
    for o in outcomes:
        if o is not None:
            telemetry.max_count = max(telemetry.max_count, o.max_count)
            telemetry.overflowed |= o.overflowed
    drawn_total = int(drawn.sum())
    cwm = classify["ci_width_mean"]
    telemetry.sampled = {
        "fraction": drawn_total / m, "n_sample": drawn_total, "n_blocks": m,
        "rounds": int(classify.get("rounds", n_rounds_run)),
        "escalated": len(esc_idx), "pruned": len(classify["pruned"]),
        "exact": False, "confidence": float(confidence),
        "ci_width_mean": None if cwm is None else float(cwm),
    }
    assert timed_out or all(o is not None for o in outcomes)
    return outcomes, timed_out, telemetry
