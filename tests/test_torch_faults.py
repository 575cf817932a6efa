"""The port's fault matrix: every fault class at every injection point.

The properties of the reference's ``tests/runtime/test_faults.py``, held
by `repro_torch.runtime`: torn tmp writes, silent array bit-rot, manifest
corruption, transient EIO/ENOSPC, crash-inside-save and kill-at-snapshot
each end in a result equal to the fault-free oracle's (the port's
``mine()``, which ``tests/test_torch_session.py`` holds against the
reference), with the expected recovery recorded in `RunHealth`.  Also the
COMMIT-chain fallback per artifact, the every-step-corrupt degradation,
in-process preemption and the env round trip.  ``level.distributed`` is
covered by the reference's two fallback tests: a distributed level that
fails is re-run on the batched plane (the result equals batched), and a
session killed after such a fallback resumes.  CPU, no JAX.
"""
import dataclasses

import pytest
import torch

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core import planner as planner_lib
from repro_torch.data.synthetic import rmat_graph
from repro_torch.runtime import (
    FaultPlan, FaultSpec, InjectedCrash, MiningSession, PreemptedError,
    faults,
)
from repro_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    faults.clear()
    yield
    faults.clear()


def _graph():
    return rmat_graph(64, 320, n_labels=2, seed=3, undirected=True)


def _cfg(metric="mis", **kw):
    kw.setdefault("sigma", 6)
    kw.setdefault("lam", 1.0)
    kw.setdefault("max_pattern_size", 3)
    kw.setdefault("match", MatchConfig(cap=512, root_block=16, chunk=16,
                                       max_chunks=4, bisect_iters=7))
    return MiningConfig(metric=metric, **kw)


def _session(g, cfg, d, **kw):
    return MiningSession(g, cfg, d, device="cpu", **kw)


def _norm(res, *, drop_level_keys=("wall_s",)):
    """Everything in a MiningResult except wall clock (and health)."""
    return dict(
        frequent=[(p.key(), s) for p, s in res.frequent],
        searched=res.searched,
        stats=[(st.pattern.key(), st.support, st.tau, st.frequent,
                st.embeddings_found, st.overflowed, st.blocks_run)
               for st in res.stats],
        per_level={k: {kk: vv for kk, vv in v.items()
                       if kk not in drop_level_keys}
                   for k, v in res.per_level.items()},
        timed_out=res.timed_out,
        peak=res.peak_device_bytes,
    )


def _run_with_faults(g, cfg, ckpt_dir, plan, *, max_restarts=10, **kw):
    """Install the plan, mine, restart on injected kills."""
    faults.install(plan)
    restarts = 0
    try:
        while True:
            try:
                return _session(g, cfg, ckpt_dir, **kw).run()
            except InjectedCrash:
                restarts += 1
                assert restarts <= max_restarts, (
                    f"fault loop livelocked after {restarts} restarts: "
                    f"{plan.fired}")
    finally:
        faults.clear()


# (id, fault specs, health event the recovery must record — None when the
# recovery is the COMMIT protocol itself, which is silent by design)
MATRIX = [
    ("save-io-eio-transient",
     [FaultSpec("save.io", "io_error", at=2, errno_name="EIO")],
     "save_retry"),
    ("save-io-enospc-transient",
     [FaultSpec("save.io", "io_error", at=1, times=2,
                errno_name="ENOSPC")],
     "save_retry"),
    ("torn-array-write",
     [FaultSpec("save.array_write", "torn_write", at=2)],
     None),
    ("manifest-corruption-then-kill",
     [FaultSpec("save.manifest", "corrupt_manifest", at=3),
      FaultSpec("session.snapshot", "crash", at=3)],
     "restore_fallback"),
    ("array-bitflip-then-kill",
     [FaultSpec("save.committed", "bitflip", at=3),
      FaultSpec("session.snapshot", "crash", at=3)],
     "restore_fallback"),
    ("crash-inside-save",
     [FaultSpec("save.pre_commit", "crash", at=2)],
     None),
    ("kill-at-first-snapshot",
     [FaultSpec("session.snapshot", "crash", at=1)],
     None),
    ("kill-at-later-snapshot",
     [FaultSpec("session.snapshot", "crash", at=4)],
     None),
]


@pytest.fixture(scope="module")
def oracle():
    return mine(_graph(), _cfg(execution="batched"), device="cpu")


@pytest.mark.parametrize("specs,expect", [m[1:] for m in MATRIX],
                         ids=[m[0] for m in MATRIX])
def test_fault_matrix_equals_oracle(tmp_path, oracle, specs, expect):
    g, cfg = _graph(), _cfg(execution="batched")
    plan = FaultPlan(specs, seed=7)
    res = _run_with_faults(g, cfg, tmp_path, plan,
                           checkpoint_every=1, keep_last=3)
    assert plan.fired, "no fault fired — the matrix cell tested nothing"
    assert _norm(res) == _norm(oracle)
    if expect is not None:
        assert res.health.count(expect) >= 1, res.health.to_dict()


# points the fallback tests below fire (the matrix runs the batched plane)
FALLBACK_POINTS = {"level.distributed"}


def test_fault_matrix_cells_cover_every_point():
    covered = {s.point for _, specs, _ in MATRIX for s in specs}
    assert covered == {p for p in faults.POINTS if p not in FALLBACK_POINTS}
    assert covered | FALLBACK_POINTS == set(faults.POINTS)


# ---------------------------------------------------------------------------
# graceful degradation: distributed → batched plane fallback
# ---------------------------------------------------------------------------

def _supports(res):
    return [(p.key(), s) for p, s in res.frequent]


def test_distributed_fallback_to_batched():
    """Every distributed level failing degrades the whole run to the
    batched plane: the forced batched run's result, plus a plane_fallback
    health event per level."""
    g = _graph()
    cfg = _cfg("mis_luby", execution="distributed")
    want = mine(g, dataclasses.replace(cfg, execution="batched"),
                device="cpu")
    faults.install(FaultPlan(
        [FaultSpec("level.distributed", "error", at=1, times=99)]))
    try:
        res = mine(g, cfg, device="cpu")
    finally:
        faults.clear()
    assert res.health.count("plane_fallback") == len(res.per_level) >= 1, \
        res.health.to_dict()
    assert _norm(res) == _norm(want)


def test_distributed_fallback_session_killed_and_resumed(tmp_path):
    """A session killed mid-level *after* the plane fallback resumes onto
    the rewritten (batched) plan: the recorded plan overrides the forced
    distributed execution for the in-flight level."""
    g = _graph()
    cfg = _cfg("mis_luby", execution="distributed")
    want = mine(g, dataclasses.replace(cfg, execution="batched"),
                device="cpu")
    plan = FaultPlan([
        FaultSpec("level.distributed", "error", at=1, times=99),
        FaultSpec("session.snapshot", "crash", at=2),
    ])
    res = _run_with_faults(g, cfg, tmp_path, plan, checkpoint_every=1,
                           keep_last=100)
    assert any(f["point"] == "session.snapshot" for f in plan.fired)
    assert res.health.count("plane_fallback") >= 1
    assert _supports(res) == _supports(want)


@pytest.mark.parametrize("artifact", ["array", "manifest", "commit"])
def test_chain_fallback_per_artifact(tmp_path, oracle, artifact):
    """Kill mid-level, corrupt one artifact of the newest step, resume:
    the previous committed step carries the run, reported in RunHealth
    (except a missing COMMIT, which the protocol treats as never
    written)."""
    g, cfg = _graph(), _cfg(execution="batched")
    faults.install(FaultPlan([FaultSpec("session.snapshot", "crash", at=3)]))
    with pytest.raises(InjectedCrash):
        _session(g, cfg, tmp_path, checkpoint_every=1, keep_last=100).run()
    faults.clear()
    ckpt.wait_pending(raise_errors=False)
    steps = ckpt.committed_steps(tmp_path)
    assert len(steps) >= 2, "need a retained chain to fall back across"
    newest = tmp_path / f"step_{steps[-1]:08d}"
    if artifact == "array":
        arrs = [f for f in sorted(newest.glob("arr_*.npy"))
                if f.stat().st_size > 128]
        assert arrs, "expected a payload-bearing mid-level snapshot"
        data = bytearray(arrs[0].read_bytes())
        data[-1] ^= 0x01  # silent payload rot — only the CRC can see it
        arrs[0].write_bytes(bytes(data))
    elif artifact == "manifest":
        (newest / "manifest.json").write_text('{"half": tru')
    else:
        (newest / "COMMIT").unlink()

    resumed = _session(g, cfg, tmp_path, checkpoint_every=1,
                       keep_last=100).run()
    assert _norm(resumed) == _norm(oracle)
    if artifact != "commit":
        assert resumed.health.count("restore_fallback") >= 1
    if artifact == "array":
        assert resumed.health.count("checksum_mismatch") >= 1


def test_chain_fallback_every_step_corrupt_degrades_to_fresh(tmp_path):
    g, cfg = _graph(), _cfg(execution="batched")
    ref = _session(g, cfg, tmp_path, checkpoint_every=0,
                   keep_last=100).run()
    steps = ckpt.committed_steps(tmp_path)
    assert steps
    for s in steps:
        (tmp_path / f"step_{s:08d}" / "manifest.json").write_text("junk")
    again = _session(g, cfg, tmp_path, checkpoint_every=0,
                     keep_last=100).run()
    assert _norm(again) == _norm(ref)
    assert again.health.count("restore_fallback") == len(steps)


def test_overflow_escalation_restores_forced_plane_equality(monkeypatch):
    """An auto-derived cap that overflows: the escalation pass re-runs the
    overflowed patterns at the base cap, and auto equals forced batched."""
    monkeypatch.setattr(planner_lib, "CAP_FLOOR", 1)
    monkeypatch.setattr(planner_lib, "CAP_HEADROOM", 1)
    g = rmat_graph(96, 700, n_labels=1, seed=11, undirected=True)
    base = MatchConfig(cap=8192, root_block=16, chunk=16, max_chunks=4,
                       bisect_iters=7)
    cfg_auto = MiningConfig(sigma=6, lam=1.0, metric="mis", complete=True,
                            max_pattern_size=3, match=base, execution="auto")
    res_auto = mine(g, cfg_auto, device="cpu")
    res_forced = mine(g, dataclasses.replace(cfg_auto, execution="batched"),
                      device="cpu")
    assert res_auto.health.count("overflow_escalation") >= 1
    # auto-only per-level diagnostics, absent from forced-batched runs
    drop = ("wall_s", "plan", "dispatches", "replans", "block_peaks")
    na = _norm(res_auto, drop_level_keys=drop)
    nf = _norm(res_forced, drop_level_keys=drop)
    na.pop("peak")
    nf.pop("peak")
    assert na == nf


def test_preempt_cuts_committed_snapshot_and_resumes(tmp_path, oracle):
    g, cfg = _graph(), _cfg(execution="batched")
    sess = _session(g, cfg, tmp_path, checkpoint_every=1)
    sess.request_preempt()
    with pytest.raises(PreemptedError):
        sess.run()
    assert ckpt.latest_step(tmp_path) is not None
    assert sess.health.count("preempted") == 1
    resumed = _session(g, cfg, tmp_path, checkpoint_every=1).run()
    assert _norm(resumed) == _norm(oracle)


def test_fault_plan_env_roundtrip(monkeypatch):
    """Subprocess runs are injected through REPRO_TORCH_FAULT_PLAN (the
    port's own variable: the reference's is never read)."""
    assert faults.FAULT_PLAN_ENV == "REPRO_TORCH_FAULT_PLAN"
    monkeypatch.setenv("REPRO_FAULT_PLAN", '[{"point": "save.io", '
                       '"kind": "crash"}]')
    monkeypatch.setenv(
        faults.FAULT_PLAN_ENV,
        '{"seed": 3, "faults": [{"point": "session.snapshot", '
        '"kind": "crash", "at": 2, "times": 1}]}')
    faults.clear()  # re-arm env pickup
    plan = faults.active()
    assert plan is not None and plan.seed == 3
    assert plan.specs == [FaultSpec("session.snapshot", "crash", at=2)]
    faults.clear()
    monkeypatch.delenv(faults.FAULT_PLAN_ENV)
    assert faults.active() is None


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("save.nowhere", "crash")
    with pytest.raises(ValueError):
        FaultSpec("save.io", "melt")
    with pytest.raises(ValueError):
        FaultSpec("save.io", "io_error", at=0)
    with pytest.raises(ValueError):
        FaultSpec("save.io", "io_error", errno_name="ENOTANERRNO")
    spec = FaultSpec("save.io", "io_error", at=2, times=3,
                     errno_name="ENOSPC")
    assert FaultSpec.from_dict(spec.to_dict()) == spec
