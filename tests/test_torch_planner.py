"""The port's execution planner and ``auto`` plane against the JAX reference.

Given the same `CostModel`, the port's `LevelPlan`s equal the reference's
(pricing record and sample draw included); ``mine()`` and the CLI's
``--json`` under ``--execution auto`` equal the reference's for every
batchable metric, with the overflow escalation a derived cap triggers
(within-level replans: `test_torch_sampled.py`); auto gives every forced plane's answer; calibration
files of schemas 1–3 load alike and the escalation-fraction EMA persists
alike.  Every calibration file lives under ``tmp_path``.
"""
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import MatchConfig as JMatchConfig
from repro.core import MiningConfig as JMiningConfig
from repro.core import build_graph as j_build_graph
from repro.core import mine as j_mine
from repro.core import planner as jplanner
from repro.core.flexis import initial_candidates as j_initial
from repro.launch import mine as j_cli

from repro_torch.core import MatchConfig as TMatchConfig
from repro_torch.core import MiningConfig as TMiningConfig
from repro_torch.core import Pattern as TPattern
from repro_torch.core import build_graph as t_build_graph
from repro_torch.core import mine as t_mine
from repro_torch.core import planner as tplanner
from repro_torch.launch import mine as t_cli

METRICS = ("mis", "mis_luby", "mni", "frac")
REPO = Path(__file__).resolve().parents[1]
# constants under which auto batches and prices (and picks) the sampled
# plane at these sizes: a large per-step overhead, no measured escalation
AUTO_CALIBRATION = {"schema": 3, "dispatch_overhead_s": 1e-2,
                    "lane_time_s": 1e-12, "row_time_s": 1e-9,
                    "vmap_factor": 1.0, "escalation_fraction": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def calibration(tmp_path, monkeypatch):
    """Point both packages at one calibration file under ``tmp_path``."""
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(AUTO_CALIBRATION))
    monkeypatch.setenv(jplanner.CALIBRATION_ENV, str(path))
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(path))
    return path


def _graphs(n, edges, labels, **kw):
    return (j_build_graph(n, edges, labels, **kw),
            t_build_graph(n, edges, labels, **kw))


def _rmat_like(n=128, m=700, seed=1):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    return _graphs(n, edges, rng.integers(0, 2, n).astype(np.int32),
                   undirected=True)


def _t_match(jc):
    return TMatchConfig(cap=jc.cap, root_block=jc.root_block, chunk=jc.chunk,
                        max_chunks=jc.max_chunks, bisect_iters=jc.bisect_iters,
                        two_phase=jc.two_phase)


def _t_pattern(p):
    return TPattern(p.adj.copy(), p.labels.copy())


def _result(res):
    per_level = {lvl: {k: v for k, v in st.items() if k != "wall_s"}
                 for lvl, st in res.per_level.items()}
    stats = [(s.pattern.key(), s.support, s.tau, s.frequent,
              s.embeddings_found, s.overflowed, s.blocks_run, s.max_count,
              s.dispatches, s.estimated) for s in res.stats]
    return dict(frequent=[(p.key(), s) for p, s in res.frequent],
                searched=res.searched, per_level=per_level, stats=stats,
                timed_out=res.timed_out, peak=res.peak_device_bytes,
                health=res.health.to_dict())


def _norm(res):
    """What every plane must agree on (as the reference's planner tests)."""
    d = _result(res)
    d.pop("health")
    d.pop("peak")
    d["stats"] = [s[:8] for s in d["stats"]]
    d["per_level"] = {lvl: {k: v for k, v in st.items()
                            if k not in ("dispatches", "plan", "sampled",
                                         "block_peaks", "replans")}
                      for lvl, st in d["per_level"].items()}
    return d


# ---------------------------------------------------------------------------
# LevelPlan parity, decision by decision
# ---------------------------------------------------------------------------

PLAN_CASES = {
    # name: (execution, metric, level, tau, prev, cfg kwargs, cost kwargs)
    "auto-first-level": ("auto", "mis", 1, 3, None, {}, {}),
    "auto-derived-cap": ("auto", "mis", 2, 2,
                         {"max_count": 7, "overflowed": False}, {}, {}),
    "auto-after-overflow": ("auto", "mis", 2, 2,
                            {"max_count": 7, "overflowed": True}, {}, {}),
    "auto-sampled-wins": ("auto", "mis", 2, 40,
                          {"sampled": {"exact": False, "escalated": 0,
                                       "pruned": 20},
                           "searched": 20, "frequent": 0}, {}, {}),
    "auto-sampled-loses": ("auto", "mis", 2, 40,
                           {"sampled": {"exact": False, "escalated": 20,
                                        "pruned": 0},
                            "searched": 20, "frequent": 20}, {}, {}),
    "auto-frontier-predictor": ("auto", "mni", 2, 40,
                                {"searched": 10, "frequent": 5,
                                 "max_count": 300, "overflowed": False,
                                 "block_peaks": list(range(4))}, {},
                                {"escalation_fraction": 0.1}),
    "auto-luby-one-pattern": ("auto", "mis_luby", 1, 3, None,
                              {"n_patterns": 1}, {}),
    "auto-complete": ("auto", "frac", 1, 40, None, {"complete": True}, {}),
    "sampled-degree": ("sampled", "mis", 1, 3, None,
                       {"sample_fraction": 0.5}, {}),
    "sampled-occupancy": ("sampled", "mis", 2, 3,
                          {"block_peaks": [5, 0, 9, 1]}, {}, {}),
    "sampled-full": ("sampled", "mis", 1, 3, None,
                     {"sample_fraction": 1.0}, {}),
    "sampled-complete": ("sampled", "mis", 1, 3, None, {"complete": True}, {}),
    "forced-batched": ("batched", "mis", 1, 3, None, {}, {}),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_level_plan_equals_reference(case):
    execution, metric, level, tau, prev, cfg_kw, cost_kw = PLAN_CASES[case]
    cfg_kw = dict(cfg_kw)
    n_pats = cfg_kw.pop("n_patterns", None)
    jg, tg = _rmat_like()
    jm = JMatchConfig.for_graph(jg, cap=4096, root_block=32)
    kw = dict(sigma=3, metric=metric, execution=execution, **cfg_kw)
    jcfg = JMiningConfig(match=jm, **kw)
    tcfg = TMiningConfig(match=_t_match(jm), **kw)
    jcost = jplanner.CostModel(dispatch_overhead_s=5e-3, lane_time_s=1e-10,
                               **cost_kw)
    tcost = tplanner.CostModel.from_dict(jcost.to_dict())
    pats = j_initial(jg)[:n_pats]
    taus = [tau] * len(pats)
    want = jplanner.ExecutionPlanner(jg, jcfg, cost_model=jcost).plan_level(
        level, pats, taus, prev=prev)
    got = tplanner.ExecutionPlanner(tg, tcfg, cost_model=tcost).plan_level(
        level, [_t_pattern(p) for p in pats], taus, prev=prev)
    assert got.to_dict() == want.to_dict()
    assert json.loads(json.dumps(got.to_dict())) == got.to_dict()
    back = tplanner.LevelPlan.from_dict(got.to_dict(), tcfg.match)
    assert back.to_dict() == got.to_dict()


def test_plan_cases_cover_every_decision():
    """The cases above reach every plane and both pricing outcomes."""
    jg, _ = _rmat_like()
    jm = JMatchConfig.for_graph(jg, cap=4096, root_block=32)
    seen = set()
    for execution, metric, level, tau, prev, cfg_kw, cost_kw in \
            PLAN_CASES.values():
        cfg_kw = dict(cfg_kw)
        n_pats = cfg_kw.pop("n_patterns", None)
        cfg = JMiningConfig(sigma=3, metric=metric, execution=execution,
                            match=jm, **cfg_kw)
        cost = jplanner.CostModel(dispatch_overhead_s=5e-3,
                                  lane_time_s=1e-10, **cost_kw)
        pats = j_initial(jg)[:n_pats]
        plan = jplanner.ExecutionPlanner(jg, cfg, cost_model=cost) \
            .plan_level(level, pats, [tau] * len(pats), prev=prev)
        seen.add(plan.plane)
        if plan.pricing is not None:
            seen.add("priced-" + plan.pricing["chosen"])
            seen.add(plan.pricing["esc_source"])
        if plan.match.cap < jm.cap:
            seen.add("derived-cap")
    assert {"sequential", "batched", "sampled", "priced-batched",
            "priced-sampled", "telemetry", "frontier",
            "derived-cap"} <= seen, seen


def test_distributed_still_raises():
    _, tg = _rmat_like()
    cfg = TMiningConfig(sigma=3, metric="mis_luby", execution="distributed",
                        match=TMatchConfig.for_graph(tg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tplanner.ExecutionPlanner(tg, cfg)
    assert TMiningConfig(sigma=2).execution == "auto"


# ---------------------------------------------------------------------------
# mine(): auto ≡ forced planes, and the reference's auto run
# ---------------------------------------------------------------------------

def _random_digraph(n, seed, n_labels=2, p=0.25):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < p
    np.fill_diagonal(m, False)
    src, dst = np.nonzero(m)
    return _graphs(n, np.stack([src, dst], 1),
                   rng.integers(0, n_labels, n).astype(np.int32),
                   n_labels=n_labels)


@pytest.mark.parametrize("metric", ("mis", "mis_luby", "mni"))
def test_auto_equals_forced_planes_and_reference(metric, calibration):
    """auto ≡ batched ≡ sequential on small random graphs (the reference's
    property), and the port's auto run equals the reference's bit for bit
    (plans included)."""
    for seed in (0,):
        jg, tg = _random_digraph(10, seed)
        jm = dataclasses.replace(
            JMatchConfig.for_graph(jg, cap=1024, root_block=4, chunk=4),
            two_phase=False)
        kw = dict(sigma=2, lam=1.0, metric=metric, max_pattern_size=3)
        runs = {ex: t_mine(tg, TMiningConfig(match=_t_match(jm),
                                             execution=ex, **kw),
                           device="cpu")
                for ex in ("auto", "batched", "sequential")}
        assert _norm(runs["auto"]) == _norm(runs["batched"]) \
            == _norm(runs["sequential"])
        for st in runs["auto"].per_level.values():
            assert st["plan"]["plane"] in ("sequential", "batched", "sampled")
        want = j_mine(jg, JMiningConfig(match=jm, execution="auto", **kw))
        assert _result(runs["auto"]) == _result(want)


def _fanout_graph():
    """Every vertex has 10 out-edges and one label: a root block of 16 holds
    160 k = 2 embeddings (derived cap: the 1 024 floor) but 1 440 out-stars,
    so level 2 overflows the derived cap and escalates to the base cap."""
    rng = np.random.default_rng(3)
    n, deg = 128, 10
    src = np.repeat(np.arange(n), deg)
    dst = (src + rng.integers(1, n, n * deg)) % n
    return _graphs(n, np.stack([src, dst], 1), np.zeros(n, np.int32))


def test_auto_overflow_escalation_equals_reference(calibration):
    jg, tg = _fanout_graph()
    jm = dataclasses.replace(
        JMatchConfig.for_graph(jg, cap=4096, root_block=16), two_phase=False)
    kw = dict(sigma=20, lam=0.4, metric="mis", max_pattern_size=3)
    got = t_mine(tg, TMiningConfig(match=_t_match(jm), execution="auto", **kw),
                 device="cpu")
    want = j_mine(jg, JMiningConfig(match=jm, execution="auto", **kw))
    assert _result(got) == _result(want)
    assert got.health.count("overflow_escalation") >= 1
    assert any(st["plan"]["cap"] < jm.cap for st in got.per_level.values())
    forced = t_mine(tg, TMiningConfig(match=_t_match(jm), execution="batched",
                                      **kw), device="cpu")
    assert _norm(got) == _norm(forced)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_FLAGS = ["--dataset", "gnutella", "--scale", "0.01", "--sigma", "10",
             "--max-size", "3", "--root-block", "8", "--sample-fraction",
             "0.5"]


def _strip_wall_clock(d):
    d = dict(d)
    d.pop("elapsed_s")
    d["per_level"] = {k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                      for k, v in d["per_level"].items()}
    return d


def cli_parity(tmp_path, monkeypatch, execution, metric):
    """Run both CLIs on the same flags, each with its own copy of one
    calibration file; their --json and the files they leave must agree."""
    monkeypatch.delenv(jplanner.CALIBRATION_ENV, raising=False)
    monkeypatch.delenv(tplanner.CALIBRATION_ENV, raising=False)
    for side in ("j", "t"):
        (tmp_path / f"{side}_cal.json").write_text(
            json.dumps(AUTO_CALIBRATION))
    flags = CLI_FLAGS + ["--metric", metric, "--execution", execution]
    assert j_cli.main(flags + ["--calibration", str(tmp_path / "j_cal.json"),
                               "--json", str(tmp_path / "j.json")]) == 0
    assert t_cli.main(flags + ["--device", "cpu", "--calibration",
                               str(tmp_path / "t_cal.json"),
                               "--json", str(tmp_path / "t.json")]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert _strip_wall_clock(got) == _strip_wall_clock(want)
    assert json.loads((tmp_path / "t_cal.json").read_text()) == \
        json.loads((tmp_path / "j_cal.json").read_text())
    return got


@pytest.mark.parametrize("metric", METRICS)
def test_cli_auto_json_equals_reference(tmp_path, monkeypatch, metric):
    got = cli_parity(tmp_path, monkeypatch, "auto", metric)
    assert all("plan" in v for v in got["per_level"].values())


def test_cli_defaults_to_auto():
    args = t_cli.build_parser().parse_args([])
    assert args.execution == "auto" and args.device == "cuda"
    assert args.calibration is None


# ---------------------------------------------------------------------------
# calibration files
# ---------------------------------------------------------------------------

def test_calibration_schemas_load_alike(tmp_path):
    files = {
        "reference": REPO / "planner_calibration.json",
        "schema1": {"schema": 1, "dispatch_overhead_s": 1e-3,
                    "lane_time_s": 1e-9, "row_time_s": 2e-6,
                    "vmap_factor": 1.1},
        "schema2": {"schema": 2, "dispatch_overhead_s": 1e-3,
                    "lane_time_s": 1e-9, "row_time_s": 2e-6,
                    "vmap_factor": 0.5, "row_time_mni_s": 1e-6},
        "schema3": dict(AUTO_CALIBRATION, escalation_fraction=0.3),
        "bad-schema": {"schema": 99, "lane_time_s": 1.0},
    }
    for name, src in files.items():
        path = tmp_path / f"{name}.json"
        if isinstance(src, Path):
            shutil.copy(src, path)
        else:
            path.write_text(json.dumps(src))
        want = jplanner.load_calibration(str(path)).to_dict()
        got = tplanner.load_calibration(str(path)).to_dict()
        if name == "bad-schema":
            # both fall back to their own built-in defaults
            assert got == tplanner.CostModel().to_dict()
            continue
        assert got == want, name
    assert tplanner.load_calibration(str(tmp_path / "nope.json")) == \
        tplanner.CostModel()
    assert tplanner.CostModel.from_dict(
        tplanner.CostModel(escalation_fraction=0.2).to_dict()) == \
        tplanner.CostModel(escalation_fraction=0.2)


def test_calibration_env_and_default_name(tmp_path, monkeypatch):
    assert tplanner.DEFAULT_CALIBRATION_FILE != \
        jplanner.DEFAULT_CALIBRATION_FILE
    assert tplanner.CALIBRATION_ENV != jplanner.CALIBRATION_ENV
    path = tmp_path / "env.json"
    path.write_text(json.dumps({"schema": 3, "lane_time_s": 7e-9}))
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(path))
    assert tplanner.load_calibration().lane_time_s == 7e-9
    monkeypatch.chdir(tmp_path)          # no file by the default name here
    monkeypatch.delenv(tplanner.CALIBRATION_ENV)
    assert tplanner.load_calibration() == tplanner.CostModel()


def test_persist_escalation_fraction_equals_reference(tmp_path):
    old = {"schema": 1, "dispatch_overhead_s": 1e-3, "lane_time_s": 1e-9,
           "row_time_s": 2e-6, "vmap_factor": 1.1}
    for side in ("j", "t"):
        (tmp_path / f"{side}_old.json").write_text(json.dumps(old))
    for measured in (0.4, 0.0, 7.5):
        for side, lib in (("j", jplanner), ("t", tplanner)):
            for name in ("new", "old"):
                path = tmp_path / f"{side}_{name}.json"
                assert lib.persist_escalation_fraction(
                    measured, path=str(path)) == str(path)
        for name in ("new", "old"):
            assert (tmp_path / f"t_{name}.json").read_text() == \
                (tmp_path / f"j_{name}.json").read_text()
    d = json.loads((tmp_path / "t_new.json").read_text())
    assert d["escalation_fraction"] == pytest.approx(0.6)
    up = json.loads((tmp_path / "t_old.json").read_text())
    assert (up["schema"], up["row_time_s"]) == (3, 2e-6)
    cm = tplanner.load_calibration(str(tmp_path / "t_old.json"))
    assert cm.esc_prior() == pytest.approx(up["escalation_fraction"])
