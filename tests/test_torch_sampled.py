"""The port's sampled plane and the batched plane's hooks against the reference.

The sampler's statistics reproduce the reference's golden values bit for bit
(so draws recorded by either package replay in the other); ``mine()`` and
the CLI's ``--json`` under ``--execution sampled`` equal the reference's,
with fraction 1.0 and with escalation off too; escalation replays the
sample pass's recorded blocks instead of matching them again; adaptive
rounds grow coverage; `_mine_group` resumed from its `GroupState` at every
block equals the run without interruption; ``mine(hooks=)`` hands out its
`MiningLoopState` at every level and resumes from it.  Calibration files
live under ``tmp_path``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import MatchConfig as JMatchConfig
from repro.core import MiningConfig as JMiningConfig
from repro.core import build_graph as j_build_graph
from repro.core import mine as j_mine
from repro.core import planner as jplanner
from repro.core import sampled as jsampled
from repro.core.batched import _mine_group as j_mine_group
from repro.core.flexis import initial_candidates as j_initial
from repro.core.graph import DeviceGraph as JDeviceGraph
from repro.core.plan import make_plan as j_make_plan

from repro_torch.core import MatchConfig as TMatchConfig
from repro_torch.core import MiningConfig as TMiningConfig
from repro_torch.core import Pattern as TPattern
from repro_torch.core import build_graph as t_build_graph
from repro_torch.core import mine as t_mine
from repro_torch.core import planner as tplanner
from repro_torch.core import sampled as tsampled
from repro_torch.core.batched import _mine_group as t_mine_group
from repro_torch.core.batched import evaluate_level_batched as t_eval_level
from repro_torch.core.flexis import MiningLoopState
from repro_torch.core.graph import DeviceGraph as TDeviceGraph
from repro_torch.core.plan import make_plan as t_make_plan

from test_torch_planner import METRICS, _result, cli_parity


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _calibration(tmp_path, monkeypatch):
    """Both packages read one calibration file under ``tmp_path`` (the
    reference's built-in constants)."""
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(jplanner.CostModel().to_dict()))
    monkeypatch.setenv(jplanner.CALIBRATION_ENV, str(path))
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(path))


def _graphs(n=64, deg=4, n_labels=3, seed=0):
    """The reference's sampled-plane test graph, built by both packages."""
    rng = np.random.default_rng(seed)
    edges = set()
    for u in range(n):
        for v in rng.integers(0, n, deg):
            if u != int(v):
                edges.add((u, int(v)))
    labels = rng.integers(0, n_labels, n).astype(np.int32)
    edges = sorted(edges)
    return (j_build_graph(n, edges, labels, n_labels=n_labels),
            t_build_graph(n, edges, labels, n_labels=n_labels))


J_MATCH = JMatchConfig(cap=256, root_block=8, chunk=8, max_chunks=2,
                       two_phase=False)
T_MATCH = TMatchConfig(cap=256, root_block=8, chunk=8, max_chunks=2,
                       two_phase=False)


def _t_patterns(pats):
    return [TPattern(p.adj.copy(), p.labels.copy()) for p in pats]


# ---------------------------------------------------------------------------
# statistics: golden values and equality with the reference
# ---------------------------------------------------------------------------

def test_rng_golden_values():
    # the reference's pinned draws (tests/core/test_sampled.py)
    assert tsampled.sample_key(0, 1) == [0, 1]
    assert tsampled.sample_key(3, 2) == [3, 2]
    k = tsampled.sample_key(0, 1)
    assert tsampled.sample_uniform(k) == 0.70962399485867
    assert tsampled.sample_uniform(k, count=1) == tsampled.sample_uniform(k)
    assert tsampled.sample_uniform(k, count=2) == 0.9795624859036957
    assert tsampled.sample_uniform(tsampled.sample_key(3, 2), count=3) \
        == 0.6850707717552736
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
    pos, pis = tsampled.systematic_sample(w, 3, 0.5)
    assert pos.tolist() == [3, 5, 7]
    assert pis.tolist() == [0.3333333333333333, 0.5, 0.6666666666666666]
    assert tsampled.inclusion_probs(w, 3).tolist() == [
        0.08333333333333333, 0.16666666666666666, 0.25,
        0.3333333333333333, 0.4166666666666667, 0.5,
        0.5833333333333334, 0.6666666666666666]
    assert tsampled.inclusion_probs(w, 3)[pos].tolist() == pis.tolist()


def test_statistics_equal_reference():
    rng = np.random.default_rng(5)
    for trial in range(20):
        m = int(rng.integers(2, 40))
        w = rng.random(m) * rng.integers(1, 50, m)
        s = int(rng.integers(0, m + 2))
        u = tsampled.sample_uniform(tsampled.sample_key(trial, 4),
                                    count=1 + trial % 3)
        assert u == jsampled.sample_uniform(jsampled.sample_key(trial, 4),
                                            count=1 + trial % 3)
        got = tsampled.systematic_sample(w, s, u)
        want = jsampled.systematic_sample(w, s, u)
        assert got[0].tolist() == want[0].tolist()
        assert got[1].tolist() == want[1].tolist()
        assert tsampled.inclusion_probs(w, s).tolist() == \
            jsampled.inclusion_probs(w, s).tolist()
        ys = rng.integers(0, 4, got[0].size).astype(float) * (trial % 4 > 0)
        for conf in (0.5, 0.95):
            assert tsampled.ht_interval(ys, got[1], m, conf) == \
                jsampled.ht_interval(ys, want[1], m, conf)
    for p in (1e-6, 0.01, 0.3, 0.5, 0.975, 1 - 1e-9):
        assert tsampled.normal_quantile(p) == jsampled.normal_quantile(p)
    for conf, f in ((0.95, 0.25), (0.9, 0.5), (0.99, 1.0)):
        assert tplanner.hidden_mass_bound(conf, f) == \
            jplanner.hidden_mass_bound(conf, f)


# ---------------------------------------------------------------------------
# mine() and the CLI
# ---------------------------------------------------------------------------

SAMPLED_VARIANTS = {
    "mni-quarter": ("mni", dict(sample_fraction=0.25, max_pattern_size=2)),
    "frac-full": ("frac", dict(sample_fraction=1.0, max_pattern_size=2)),
    "luby-no-escalation": ("mis_luby", dict(sample_fraction=0.5,
                                            escalate=False)),
}


@pytest.mark.parametrize("variant", sorted(SAMPLED_VARIANTS))
def test_mine_sampled_equals_reference(variant):
    metric, kw = SAMPLED_VARIANTS[variant]
    kw = dict(dict(sigma=6, max_pattern_size=3), **kw)
    jg, tg = _graphs()
    want = j_mine(jg, JMiningConfig(metric=metric, execution="sampled",
                                    match=J_MATCH, **kw))
    got = t_mine(tg, TMiningConfig(metric=metric, execution="sampled",
                                   match=T_MATCH, **kw), device="cpu")
    assert _result(got) == _result(want)
    tel = [lvl["sampled"] for lvl in got.per_level.values()
           if "sampled" in lvl]
    assert tel
    if kw["sample_fraction"] == 1.0:
        assert all(t["exact"] and t["escalated"] == 0 for t in tel)
    if not kw.get("escalate", True):
        assert any(st.estimated for st in got.stats)
        assert all(t["escalated"] == 0 for t in tel if not t["exact"])


@pytest.mark.parametrize("metric", METRICS)
def test_cli_sampled_json_equals_reference(tmp_path, monkeypatch, metric):
    got = cli_parity(tmp_path, monkeypatch, "sampled", metric)
    assert all("sampled" in v for v in got["per_level"].values())


# ---------------------------------------------------------------------------
# one level: escalation reuse, adaptive rounds
# ---------------------------------------------------------------------------

def _level(fraction=0.5):
    jg, tg = _graphs()
    cfg = JMiningConfig(sigma=6, max_pattern_size=3, execution="sampled",
                        sample_fraction=fraction, match=J_MATCH)
    pats = j_initial(jg)
    plan = jplanner.ExecutionPlanner(
        jg, cfg, cost_model=jplanner.CostModel()).plan_level(
            1, pats, [3] * len(pats))
    assert plan.plane == "sampled" and plan.sample is not None
    tdev = TDeviceGraph.from_host(tg, "cpu")
    exact, timed, _ = t_eval_level(tg, tdev, _t_patterns(pats),
                                   [1] * len(pats), "mis", T_MATCH,
                                   complete=True)
    assert not timed
    return jg, tg, tdev, pats, plan, exact


def _sampled_pair(jg, tg, tdev, pats, taus, plan, **kw):
    jc, tc = {}, {}
    want = jsampled.evaluate_level_sampled(
        jg, JDeviceGraph.from_host(jg), pats, taus, "mis", J_MATCH,
        sample=plan.sample, max_batch=64, counters=jc, **kw)
    got = tsampled.evaluate_level_sampled(
        tg, tdev, _t_patterns(pats), taus, "mis", T_MATCH,
        sample=plan.sample, max_batch=64, counters=tc, **kw)
    assert [dataclasses.astuple(o) for o in got[0]] == \
        [dataclasses.astuple(o) for o in want[0]]
    assert got[2].sampled == want[2].sampled
    assert (got[2].dispatches, got[2].max_count, got[2].overflowed) == \
        (want[2].dispatches, want[2].max_count, want[2].overflowed)
    np.testing.assert_array_equal(got[2].block_peaks, want[2].block_peaks)
    assert tc == jc
    return got, tc


def test_escalation_reuse_never_rematches_sampled_blocks():
    """τ one above every true support: nothing exits early and nothing
    prunes, so escalation walks the whole schedule — replaying every
    sampled block and matching only the others."""
    jg, tg, tdev, pats, plan, exact = _level()
    taus = [o.support + 1 for o in exact]
    (outs, timed, tel), counters = _sampled_pair(
        jg, tg, tdev, pats, taus, plan, sample_rounds=1)
    s = tel.sampled
    assert s["escalated"] == len(pats) and s["pruned"] == 0
    assert s["ci_width_mean"] is None
    m = -(-tg.n // T_MATCH.root_block)
    assert counters["replay_blocks"] == s["n_sample"]
    assert counters["match_blocks"] == m - s["n_sample"]
    for o, e in zip(outs, exact):
        assert not o.estimated
        assert (o.support, o.embeddings_found, o.overflowed) == \
            (e.support, e.embeddings_found, e.overflowed)


def test_adaptive_rounds_grow_coverage():
    jg, tg, tdev, pats, plan, exact = _level()
    taus = [10 ** 6 if i % 2 == 0 else exact[i].support + 1
            for i in range(len(pats))]
    (outs, timed, tel), _ = _sampled_pair(jg, tg, tdev, pats, taus, plan,
                                          sample_rounds=3)
    s = tel.sampled
    assert s["pruned"] >= 1 and s["escalated"] >= 1
    assert s["rounds"] >= 2 and s["n_sample"] > plan.sample["n_sample"]
    for i, (o, e) in enumerate(zip(outs, exact)):
        if taus[i] == 10 ** 6:
            assert o.estimated and not o.frequent
        else:
            assert (o.support, o.embeddings_found) == (e.support,
                                                       e.embeddings_found)


# ---------------------------------------------------------------------------
# _mine_group: resume at every block; mine(hooks=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ("mis", "frac"))
def test_group_resume_at_every_block(metric):
    """Kill the group after any block and continue from the `GroupState` it
    handed out: the outcome is the uninterrupted run's (and the
    reference's), including the re-stacked buckets and the replanned cap."""
    jg, tg = _graphs()
    pats = j_initial(jg)[:12]
    taus = [2 + i % 4 for i in range(len(pats))]
    match = dataclasses.replace(T_MATCH, cap=4096)
    plans = [t_make_plan(p, tg) for p in _t_patterns(pats)]
    tdev = TDeviceGraph.from_host(tg, "cpu")
    states = []
    kw = dict(complete=False, n=tg.n, replan=True)
    full = t_mine_group(tdev, plans, taus, metric, match,
                        on_block=states.append, **kw)
    want = j_mine_group(JDeviceGraph.from_host(jg),
                        [j_make_plan(p, jg) for p in pats], taus, metric,
                        dataclasses.replace(J_MATCH, cap=4096), **kw)
    assert [dataclasses.astuple(o) for o in full[0]] == \
        [dataclasses.astuple(o) for o in want[0]]
    assert (full[2], full[3].tolist(), full[4]) == \
        (want[2], want[3].tolist(), want[4])
    assert len(states) >= 2
    if metric == "mis":                            # early exit, a shrink
        assert full[4] >= 1                        # and a replan happened
    for gs in states:
        got = t_mine_group(tdev, plans, taus, metric, match, resume=gs, **kw)
        assert [dataclasses.astuple(o) for o in got[0]] == \
            [dataclasses.astuple(o) for o in full[0]]
        assert (got[2], got[3].tolist(), got[4]) == \
            (full[2], full[3].tolist(), full[4])


class _Recorder:
    """A recording hooks object: level-boundary states, group states."""

    def __init__(self, resume=None):
        self.resume = resume
        self.states = []
        self.group_states = 0
        self.plans = []

    def loop_resume(self):
        return self.resume

    def level_hooks(self, level):
        rec = self

        class Level:
            def resume_outcomes(self):
                return None

            def resume_dispatches(self):
                return 0

            def group_resume(self, k, lo):
                return None

            def on_group_state(self, k, lo, state):
                rec.group_states += 1

            def on_group_done(self, *a, **kw):
                pass

            def record_plan(self, d):
                rec.plans.append(d)

        return Level()

    def on_level_end(self, state):
        self.states.append(state)


@pytest.mark.parametrize("execution", ("auto", "sampled"))
def test_mine_hooks_record_and_resume(execution):
    jg, tg = _graphs()
    cfg = TMiningConfig(sigma=6, max_pattern_size=3, execution=execution,
                        sample_fraction=0.5, match=T_MATCH)
    plain = t_mine(tg, cfg, device="cpu")
    rec = _Recorder()
    hooked = t_mine(tg, cfg, device="cpu", hooks=rec)
    assert _result(hooked) == _result(plain)
    assert [s.level for s in rec.states] == sorted(plain.per_level)
    assert rec.states[-1].cp == [] and rec.group_states > 0
    assert rec.plans == [st["plan"] for st in plain.per_level.values()]
    first = rec.states[0]
    assert isinstance(first, MiningLoopState) and first.cp
    resumed = t_mine(tg, cfg, device="cpu", hooks=_Recorder(resume=first))
    assert _result(resumed) == _result(plain)
