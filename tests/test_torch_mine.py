"""The port's mining loop and CLI against the JAX reference, on the CPU.

``evaluate_level_batched`` outcomes, ``mine()`` on the batched and the
sequential planes for every metric, and the CLI's ``--json`` must equal the
reference's (all but wall-clock fields), ``--execution distributed`` too.
Also: importing the port never
imports JAX or ``repro``, and asking for CUDA without a card raises before
any work is done.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import MatchConfig as JMatchConfig
from repro.core import MiningConfig as JMiningConfig
from repro.core import mine as j_mine
from repro.core.batched import evaluate_level_batched as j_eval_level
from repro.core.flexis import initial_candidates as j_initial
from repro.core.generation import generate_new_patterns as j_generate
from repro.core.graph import DeviceGraph as JDeviceGraph
from repro.data.synthetic import paper_dataset as j_dataset
from repro.launch import mine as j_cli

from repro_torch.core import MatchConfig as TMatchConfig
from repro_torch.core import MiningConfig as TMiningConfig
from repro_torch.core import Pattern as TPattern
from repro_torch.core import mine as t_mine
from repro_torch.core.batched import evaluate_level_batched as t_eval_level
from repro_torch.core.graph import DeviceGraph as TDeviceGraph
from repro_torch.data.synthetic import paper_dataset as t_dataset
from repro_torch.launch import mine as t_cli
from repro_torch.testing.shared import SharedParts

METRICS = ("mis", "mis_luby", "mni", "frac")
REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "src/repro_torch/testing/golden/gnutella_s0.1_sigma20_mis.json"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _t_match(jc):
    return TMatchConfig(cap=jc.cap, root_block=jc.root_block, chunk=jc.chunk,
                        max_chunks=jc.max_chunks, bisect_iters=jc.bisect_iters,
                        two_phase=jc.two_phase)


def _configs(g, metric, execution):
    jm = JMatchConfig.for_graph(g, cap=1024, root_block=16)
    kw = dict(sigma=4, lam=0.4, metric=metric, max_pattern_size=3,
              execution=execution)
    return JMiningConfig(match=jm, **kw), TMiningConfig(match=_t_match(jm), **kw)


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


EXECUTIONS = ("batched", "sequential")
# plane-major: the metrics of one plane share most of the reference's
# compiled programs, the two planes of a metric hardly any
MINE_CASES = [(m, ex) for ex in EXECUTIONS for m in METRICS]
METRIC_PAIRS = (METRICS[:2], METRICS[2:])


def _mine_refs(execution, metrics):
    """The reference's mine() for some metrics on one plane, in one
    process: the second run reuses the first's compiled programs."""
    def compute(_):
        g = j_dataset("gnutella", scale=0.005)
        return {("mine", m, execution): _result(j_mine(g, _configs(
            g, m, execution)[0])) for m in metrics}
    return [("mine", m, execution) for m in metrics], compute


@pytest.fixture(scope="module")
def mine_ref(tmp_path_factory):
    """The reference runs of `test_mine_equals_reference`, each part (two
    metrics on one plane: two neighbouring cases) once for the test
    session (`SharedParts`)."""
    return SharedParts(tmp_path_factory, "torch-mine-ref", {
        f"{ex}-{'-'.join(ms)}": _mine_refs(ex, ms)
        for ex in EXECUTIONS for ms in METRIC_PAIRS})


@pytest.mark.parametrize("metric,execution", MINE_CASES,
                         ids=[f"{m}-{ex}" for m, ex in MINE_CASES])
def test_mine_equals_reference(mine_ref, metric, execution):
    _, tcfg = _configs(j_dataset("gnutella", scale=0.005), metric, execution)
    got = _result(t_mine(t_dataset("gnutella", scale=0.005), tcfg,
                         device="cpu"))
    want = mine_ref[("mine", metric, execution)]
    assert got == want
    assert want["searched"] > 0 and any(v["frequent"]
                                        for v in want["per_level"].values())


EVAL_METRICS = ("mis", "frac")


def _eval_level_inputs():
    g = j_dataset("gnutella", scale=0.005)
    k2 = j_initial(g)
    pats = k2 + j_generate(k2[:8])[:12]          # mixed k in one level
    taus = [2 + i % 5 for i in range(len(pats))]
    jm = dataclasses.replace(JMatchConfig.for_graph(g, cap=1024, root_block=8,
                                                    chunk=4), two_phase=False)
    return g, pats, taus, jm


def _eval_level_refs(_):
    """The reference's evaluate_level_batched for both metrics in one
    process: the second reuses most of the first's compiled programs."""
    g, pats, taus, jm = _eval_level_inputs()
    return {("eval", m): j_eval_level(g, JDeviceGraph.from_host(g), pats,
                                      taus, m, jm, max_batch=8)
            for m in EVAL_METRICS}


@pytest.fixture(scope="module")
def eval_level_ref(tmp_path_factory):
    """The reference runs of `test_evaluate_level_batched_equals_reference`,
    once for the test session (`SharedParts`, one part)."""
    return SharedParts(tmp_path_factory, "torch-eval-level-ref", {
        "both": ([("eval", m) for m in EVAL_METRICS], _eval_level_refs)})


@pytest.mark.parametrize("metric", EVAL_METRICS)
def test_evaluate_level_batched_equals_reference(eval_level_ref, metric):
    _, pats, taus, jm = _eval_level_inputs()
    want, w_to, w_tel = eval_level_ref[("eval", metric)]
    tg = t_dataset("gnutella", scale=0.005)
    got, g_to, g_tel = t_eval_level(
        tg, TDeviceGraph.from_host(tg, "cpu"),
        [TPattern(p.adj.copy(), p.labels.copy()) for p in pats], taus, metric,
        _t_match(jm), max_batch=8)
    assert [dataclasses.astuple(o) for o in want] == \
        [dataclasses.astuple(o) for o in got]
    assert (w_to, w_tel.state_bytes, w_tel.dispatches, w_tel.max_count,
            w_tel.overflowed) == (g_to, g_tel.state_bytes, g_tel.dispatches,
                                  g_tel.max_count, g_tel.overflowed)
    np.testing.assert_array_equal(w_tel.block_peaks, g_tel.block_peaks)


def _strip_wall_clock(d):
    d = dict(d)
    d.pop("elapsed_s")
    d["per_level"] = {k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                      for k, v in d["per_level"].items()}
    return d


@pytest.mark.parametrize("metric", ["mis", "frac"])
def test_cli_json_equals_reference(tmp_path, metric):
    flags = ["--dataset", "gnutella", "--scale", "0.005", "--sigma", "4",
             "--max-size", "3", "--execution", "batched", "--metric", metric]
    assert j_cli.main(flags + ["--json", str(tmp_path / "j.json")]) == 0
    assert t_cli.main(flags + ["--device", "cpu",
                               "--json", str(tmp_path / "t.json")]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert _strip_wall_clock(got) == _strip_wall_clock(want)


def test_golden_has_no_overflow():
    # the golden the card run is held to is the reference CLI's --json for
    # --dataset gnutella --scale 0.1 --sigma 20 --lam 0.4 --max-size 3
    # --execution batched --metric mis; with no level overflowing, the
    # reference's two-phase pipeline and the single-phase kernel must agree
    want = json.loads(GOLDEN.read_text())
    assert (want["dataset"], want["scale"], want["sigma"], want["lam"],
            want["metric"], want["execution"]) == \
        ("gnutella", 0.1, 20, 0.4, "mis", "batched")
    assert not any(v["overflowed"] for v in want["per_level"].values())
    assert want["n_frequent"] > 0


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = t_dataset("gnutella", scale=0.005)
    cfg = TMiningConfig(sigma=4, match=TMatchConfig.for_graph(g))
    called = []
    monkeypatch.setattr("repro_torch.core.batched.evaluate_level_batched",
                        lambda *a, **k: called.append(1))
    with pytest.raises(RuntimeError, match="cuda"):
        t_mine(g, cfg)                       # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["--scale", "0.005"])     # --device defaults to cuda
    assert not called


@pytest.mark.parametrize("execution", ["distributed"])
def test_distributed_cli_equals_reference(tmp_path, execution):
    """The plane that raised until it was ported: the CLI's
    ``--execution distributed`` without torchrun's environment (a mesh of
    one) writes the reference CLI's ``--json`` at one device, minus wall
    clock; ``--metric mis`` is forced to ``mis_luby`` by both."""
    flags = ["--dataset", "gnutella", "--scale", "0.005", "--sigma", "4",
             "--max-size", "3", "--execution", execution, "--metric", "mis"]
    assert j_cli.main(flags + ["--json", str(tmp_path / "j.json")]) == 0
    assert t_cli.main(flags + ["--device", "cpu",
                               "--json", str(tmp_path / "t.json")]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert _strip_wall_clock(got) == _strip_wall_clock(want)
    assert got["metric"] == "mis_luby" and got["n_frequent"] > 0
    assert not got["health"]["events"]
