"""The port's checkpointed mining sessions against the reference, on the CPU.

* The codec: the same `SessionState`, built from the same patterns and
  numpy arrays, encodes to an equal ``extra`` and bit-equal leaves in both
  packages (a level boundary; a batched in-flight cursor for mis,
  mis_luby, mni and frac; a sampled cursor carrying replay rows), and
  decodes back.
* One reference session and one port session on the same tiny graph, cut
  by the same fault plan at the same snapshot, leave equal committed
  snapshots (fields that may differ are listed at `_MAY_DIFFER`).
* A port session killed after its i-th snapshot, for every i, resumes to
  the uninterrupted session's result — batched mis, mis_luby, mni and
  frac, and mis under ``auto`` and ``sampled`` — and the uninterrupted
  session equals the reference's ``mine()``.  The reference runs once per
  module (a module-scoped fixture).
* Refusals (fingerprint, sample knobs), resume modes, the pinned
  calibration, a crash inside a save, and the CLI: SIGTERM → exit 75 →
  rerun, whose ``--json`` equals the reference CLI's.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import MatchConfig as JMatchConfig
from repro.core import MiningConfig as JMiningConfig
from repro.core import Pattern as JPattern
from repro.core import mine as j_mine
from repro.core import planner as jplanner
from repro.core.batched import GroupState as JGroupState
from repro.core.batched import PatternOutcome as JOutcome
from repro.core.flexis import MiningLoopState as JLoop
from repro.core.flexis import PatternStats as JStats
from repro.data.synthetic import rmat_graph as j_rmat
from repro.launch import mine as j_cli
from repro.runtime import FaultPlan as JFaultPlan
from repro.runtime import FaultSpec as JFaultSpec
from repro.runtime import InjectedCrash as JInjectedCrash
from repro.runtime import MiningSession as JMiningSession
from repro.runtime import faults as jfaults
from repro.runtime import state as jstate

from repro_torch.core import MatchConfig, MiningConfig, Pattern, mine
from repro_torch.core import planner as tplanner
from repro_torch.core.batched import GroupState, PatternOutcome
from repro_torch.core.flexis import MiningLoopState, PatternStats
from repro_torch.data.synthetic import rmat_graph
from repro_torch.launch import mine as t_cli
from repro_torch.runtime import (
    FaultPlan, FaultSpec, InjectedCrash, MiningSession, SessionMismatch,
    faults, load_session, session_fingerprint,
)
from repro_torch.runtime import state as tstate
from repro_torch.testing.shared import shared_result
from repro_torch.train import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
EXIT_PREEMPTED = 75


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """No leaked fault plan; both packages read one calibration file (the
    reference's built-in constants) under ``tmp_path``."""
    faults.clear()
    jfaults.clear()
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(jplanner.CostModel().to_dict()))
    monkeypatch.setenv(jplanner.CALIBRATION_ENV, str(path))
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(path))
    yield
    faults.clear()
    jfaults.clear()


class Boom(Exception):
    """Stands in for SIGKILL: aborts the session mid-run."""


def _graph():
    return rmat_graph(64, 320, n_labels=2, seed=3, undirected=True)


_MATCH = dict(cap=512, root_block=16, chunk=16, max_chunks=4, bisect_iters=7)
_SAMPLED_MATCH = dict(_MATCH, root_block=8)


def _cfg(metric="mis", **kw):
    kw.setdefault("sigma", 6)
    kw.setdefault("lam", 1.0)
    kw.setdefault("max_pattern_size", 3)
    kw.setdefault("match", MatchConfig(**_MATCH))
    return MiningConfig(metric=metric, **kw)


def _session(g, cfg, d, **kw):
    return MiningSession(g, cfg, d, device="cpu", **kw)


def _norm(res):
    """Everything in a MiningResult except wall-clock fields."""
    return dict(
        frequent=[(p.key(), s) for p, s in res.frequent],
        searched=res.searched,
        stats=[(st.pattern.key(), st.support, st.tau, st.frequent,
                st.embeddings_found, st.overflowed, st.blocks_run,
                st.max_count, st.dispatches, st.estimated)
               for st in res.stats],
        per_level={k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                   for k, v in res.per_level.items()},
        timed_out=res.timed_out,
        peak=res.peak_device_bytes,
    )


def _killed_session(g, cfg, ckpt_dir, kill_at, **kw):
    """Run a port session that dies right after its kill_at-th snapshot;
    True if the bomb fired."""
    sess = _session(g, cfg, ckpt_dir, **kw)
    orig, count = sess._save, [0]

    def bomb(state):
        orig(state)
        count[0] += 1
        if count[0] >= kill_at:
            raise Boom()

    sess._save = bomb
    try:
        sess.run()
        return False
    except Boom:
        return True


# ---------------------------------------------------------------------------
# the codec against the reference's
# ---------------------------------------------------------------------------

def _pattern_pair(k, seed):
    rng = np.random.default_rng(seed)
    adj = np.zeros((k, k), bool)
    for v in range(1, k):
        u = int(rng.integers(0, v))
        adj[u, v] = True
        if rng.random() < 0.5:
            adj[v, u] = True
    labels = rng.integers(0, 3, k).astype(np.int32)
    return JPattern(adj.copy(), labels.copy()), Pattern(adj.copy(),
                                                        labels.copy())


def _loops():
    (j1, t1), (j2, t2), (j3, t3) = (_pattern_pair(2, 1), _pattern_pair(3, 2),
                                    _pattern_pair(3, 3))
    common = dict(
        level=2,
        per_level={1: {"candidates": 2, "searched": 2, "pruned": 0,
                       "frequent": 1, "dispatches": 3, "max_count": 9,
                       "overflowed": False, "wall_s": 0.25,
                       "plan": {"plane": "batched", "cap": 512}}},
        searched=2, peak_bytes=1234, elapsed_s=1.5, timed_out=False)
    stat = dict(support=3, tau=2, frequent=True, embeddings_found=11,
                overflowed=False, blocks_run=4, max_count=7, dispatches=4,
                estimated=False)
    jl = JLoop(cp=[j2, j3], frequent=[(j1, 7)],
               stats=[JStats(pattern=j1, **stat)], **common)
    tl = MiningLoopState(cp=[t2, t3], frequent=[(t1, 7)],
                         stats=[PatternStats(pattern=t1, **stat)], **common)
    return jl, tl


def _inflight_pair(metric, seed=0):
    """The same in-flight group in both packages' types: the reference's
    uint32 bitmap words and the port's int32 tensor of the same bits."""
    rng = np.random.default_rng(seed)
    P, k, n = 4, 3, 70
    host = dict(
        next_block=3, bucket_map=np.array([0, 2, -1, -1], np.int64),
        supports=np.array([1, 5, 2], np.int64),
        found=np.array([10, 20, 30], np.int64),
        overflowed=np.array([False, True, False]),
        blocks_run=np.array([3, 3, 2], np.int64), dispatches=3,
        max_count=np.array([4, 9, 2], np.int64),
        block_peaks=np.array([9, 3, 0, 0, 1], np.int64), cap=256, replans=1)
    if metric in ("mis", "mis_luby"):
        words = rng.integers(0, 2**32, (P, (n + 31) // 32),
                             dtype=np.uint64).astype(np.uint32)
        counts = rng.integers(0, 9, P).astype(np.int32)
        jstate_ = (words, counts)
        tstate_ = (torch.as_tensor(words.view(np.int32).copy()),
                   torch.as_tensor(counts))
    elif metric == "mni":
        jstate_ = rng.random((P, k, n)) < 0.3
        tstate_ = torch.as_tensor(jstate_.copy())
    else:
        jstate_ = (rng.random((P, k, n)) * 3).astype(np.float32)
        tstate_ = torch.as_tensor(jstate_.copy())
    return (JGroupState(state=jstate_, **host),
            GroupState(state=tstate_, **{a: (b.copy() if isinstance(
                b, np.ndarray) else b) for a, b in host.items()}))


def _outcomes(mod):
    return [mod(support=4, frequent=True, embeddings_found=9,
                overflowed=False, blocks_run=5, max_count=3),
            mod(support=1, frequent=False, embeddings_found=2,
                overflowed=True, blocks_run=5, max_count=8, estimated=True)]


def _sampled_groups(port: bool):
    """A sampled cursor's groups with replay rows: lists (reference) or
    int32 arrays (port), including an empty record."""
    rows = [[3, 4], [5, 6], [7, 8]]
    emb = (lambda r: np.asarray(r, np.int32).reshape(-1, 2)) if port \
        else (lambda r: r)
    rec = {"3": {"emb": emb(rows), "found": 3, "ovf": False, "peak": 3},
           "7": {"emb": emb([]), "found": 0, "ovf": False, "peak": 0}}
    return {"2:0:r0": {
        "idxs": [0, 1], "ys": [[1, 0], [2, 1]],
        "outs": [{"support": 1, "frequent": False, "embeddings_found": 3,
                  "overflowed": False, "blocks_run": 2, "max_count": 3,
                  "estimated": False}] * 2,
        "dispatches": 2, "block_peaks": [3, 0, 0, 1],
        "replay": [rec, dict(rec)]}}


def _states(case, metric):
    """(reference SessionState, port SessionState) for one codec case."""
    jl, tl = _loops()
    cal = {**jplanner.CostModel().to_dict(), "n_devices": 1}
    if case == "boundary":
        return (jstate.SessionState(loop=jl, calibration=cal),
                tstate.SessionState(loop=tl, calibration=cal))
    done = dict(k=2, lo=0, idxs=[0, 1], dispatches=5,
                block_peaks=[1, 2, 3, 4, 5], replans=0)
    jgd = jstate.GroupDone(outcomes=_outcomes(JOutcome), **done)
    tgd = tstate.GroupDone(outcomes=_outcomes(PatternOutcome), **done)
    plan = {"plane": "sampled", "cap": 512, "max_batch": 64}
    if case == "inflight":
        jg, tg = _inflight_pair(metric)
        jc = jstate.LevelCursor(level=3, groups_done=[jgd],
                                inflight_key=(3, 0), inflight_group=jg,
                                plan=plan)
        tc = tstate.LevelCursor(level=3, groups_done=[tgd],
                                inflight_key=(3, 0), inflight_group=tg,
                                plan=plan)
    else:  # "sampled": a sample-phase cursor with replay rows
        common = dict(phase="sample", positions=[0, 3, 7], key=[0, 3],
                      rounds=[{"round": 1, "n_new": 1, "positions": [5],
                               "pis": [0.5]}])
        jc = jstate.LevelCursor(
            level=3, groups_done=[jgd], plan=plan,
            sampled=jstate.SampledCursor(groups=_sampled_groups(False),
                                         **common))
        tc = tstate.LevelCursor(
            level=3, groups_done=[tgd], plan=plan,
            sampled=tstate.SampledCursor(groups=_sampled_groups(True),
                                         **common))
    return (jstate.SessionState(loop=jl, cursor=jc, calibration=cal),
            tstate.SessionState(loop=tl, cursor=tc, calibration=cal))


CODEC_CASES = ([("boundary", "mis")]
               + [("inflight", m) for m in ("mis", "mis_luby", "mni", "frac")]
               + [("sampled", "mis")])


@pytest.mark.parametrize("case,metric", CODEC_CASES,
                         ids=[f"{c}-{m}" for c, m in CODEC_CASES])
def test_codec_equals_reference(case, metric):
    js, ts = _states(case, metric)
    j_leaves, j_extra = jstate.encode_session(js, metric)
    t_leaves, t_extra = tstate.encode_session(ts, metric)
    as_json = lambda d: json.loads(json.dumps(d))  # noqa: E731
    assert as_json(t_extra) == as_json(j_extra)
    assert len(t_leaves) == len(j_leaves) == (0 if case != "inflight"
                                              else 2 if "mis" in metric
                                              else 1)
    for a, b in zip(t_leaves, j_leaves):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    # decode (after the manifest's JSON round trip) gives the state back,
    # and reads the reference's snapshot the same way
    for leaves, extra in ((t_leaves, t_extra), (j_leaves, j_extra)):
        back = tstate.decode_session([np.asarray(x) for x in leaves],
                                     as_json(extra), metric, device="cpu")
        assert [p.key() for p in back.loop.cp] == [p.key() for p in ts.loop.cp]
        assert back.loop.per_level == ts.loop.per_level
        assert back.calibration == ts.calibration
        again = tstate.encode_session(back, metric)
        assert as_json(again[1]) == as_json(t_extra)
        for a, b in zip(again[0], t_leaves):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        if case == "inflight":
            gs = back.cursor.inflight_group
            st = gs.state if "mis" in metric else (gs.state,)
            assert all(isinstance(x, torch.Tensor) for x in st)
            if "mis" in metric:
                assert st[0].dtype == torch.int32
        if case == "sampled":
            rep = back.cursor.sampled.groups["2:0:r0"]["replay"][0]
            assert rep["3"]["emb"].dtype == np.int32
            assert rep["3"]["emb"].shape == (3, 2)
            assert rep["7"]["emb"].shape == (0, 2)


def test_distributed_cursor_raises():
    """The distributed plane's in-flight cursor (decoding it raised until
    the plane was ported) round-trips through both codecs: equal extras
    and leaves, the reference's codec decodes the port's snapshot and the
    port's codec the reference's, leaf by leaf (bit 31 of a word set)."""
    from repro.core.distributed import SuperBlockState as JSuper

    from repro_torch.interop import (
        super_block_state_from_numpy, super_block_state_to_numpy,
    )

    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (3, 4), dtype=np.uint64).astype(np.uint32)
    words[0, 0] |= np.uint32(1 << 31)
    js = JSuper(next_block=6, bitmaps=words,
                counts=np.array([3, 0, 7], np.int32),
                found=np.array([40, 0, 93], np.int64),
                overflowed=np.array([False, False, True]),
                blocks_run=np.array([6, 3, 6], np.int64), super_blocks_run=2,
                dispatches=3, max_count=np.array([11, 0, 64], np.int64))
    ts = super_block_state_from_numpy(js)
    assert ts.bitmaps.dtype == torch.int32
    jl, tl = _loops()
    cal = {**jplanner.CostModel().to_dict(), "n_devices": 2}
    plan = {"plane": "distributed", "cap": 512, "max_batch": 64}
    j_leaves, j_extra = jstate.encode_session(jstate.SessionState(
        loop=jl, calibration=cal, cursor=jstate.LevelCursor(
            level=2, groups_done=[], inflight_key=(3, 0), inflight_super=js,
            plan=plan)), "mis_luby")
    t_leaves, t_extra = tstate.encode_session(tstate.SessionState(
        loop=tl, calibration=cal, cursor=tstate.LevelCursor(
            level=2, groups_done=[], inflight_key=(3, 0), inflight_super=ts,
            plan=plan)), "mis_luby")
    as_json = lambda d: json.loads(json.dumps(d))  # noqa: E731
    assert as_json(t_extra) == as_json(j_extra)
    assert t_extra["level_cursor"]["inflight"]["plane"] == "distributed"
    assert len(t_leaves) == len(j_leaves) == 2
    for a, b in zip(t_leaves, j_leaves):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    def leaves_of(ss):
        d = ss if isinstance(ss, dict) else vars(ss)
        return {k: np.asarray(v).tolist() for k, v in d.items()}

    want = leaves_of(js)
    # the port's snapshot through the reference's codec
    back = jstate.decode_session(t_leaves, as_json(t_extra), "mis_luby")
    assert back.cursor.inflight_key == (3, 0)
    assert leaves_of(back.cursor.inflight_super) == want
    # the reference's snapshot through the port's codec
    back = tstate.decode_session([np.asarray(x) for x in j_leaves],
                                 as_json(j_extra), "mis_luby", device="cpu")
    ss = back.cursor.inflight_super
    assert back.cursor.inflight_key == (3, 0) and back.cursor.plan == plan
    assert ss.bitmaps.dtype == torch.int32
    assert leaves_of(super_block_state_to_numpy(ss)) == want
    assert as_json(tstate.encode_session(back, "mis_luby")[1]) \
        == as_json(t_extra)


# ---------------------------------------------------------------------------
# the reference, once per module
# ---------------------------------------------------------------------------

_KILL_AT = 5   # a mid-level-1 snapshot of the batched complete run


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's mine() and its session cut at snapshot `_KILL_AT`,
    on the port's test graph (batched, mis, complete); once for the test
    session (`shared_result`)."""
    return shared_result(tmp_path_factory, "torch-session-reference",
                         _reference)


def _reference(d: Path):
    cal = d / "cal.json"
    cal.write_text(json.dumps(jplanner.CostModel().to_dict()))
    old = os.environ.get(jplanner.CALIBRATION_ENV)
    os.environ[jplanner.CALIBRATION_ENV] = str(cal)
    try:
        g = j_rmat(64, 320, n_labels=2, seed=3, undirected=True)
        cfg = JMiningConfig(sigma=6, lam=1.0, metric="mis", complete=True,
                            execution="batched", max_pattern_size=3,
                            match=JMatchConfig(**_MATCH))
        res = j_mine(g, cfg)
        jfaults.install(JFaultPlan(
            [JFaultSpec("session.snapshot", "crash", at=_KILL_AT)]))
        try:
            with pytest.raises(JInjectedCrash):
                JMiningSession(g, cfg, d / "ckpt", checkpoint_every=1,
                               keep_last=100, async_saves=False).run()
        finally:
            jfaults.clear()
    finally:
        if old is None:
            os.environ.pop(jplanner.CALIBRATION_ENV, None)
        else:
            os.environ[jplanner.CALIBRATION_ENV] = old
    return res, d / "ckpt", cal


def _ref_cfg():
    return _cfg("mis", complete=True, execution="batched")


def test_session_equals_reference_mine(tmp_path, reference):
    g, cfg = _graph(), _ref_cfg()
    want = reference[0]
    sess = _session(g, cfg, tmp_path, checkpoint_every=1)
    got = sess.run()
    assert _norm(got) == _norm(want)
    assert sess.snapshots_written >= 3
    # a finished session re-materializes its result without re-mining
    again = _session(g, cfg, tmp_path)
    assert _norm(again.run()) == _norm(want)
    assert again.snapshots_written == 0


# what may differ between the two packages' snapshots of one point
_MAY_DIFFER = {
    "manifest": ("time", "treedef"),
    "config": ("expansion", "pallas_interpret"),   # the reference's JAX-only
}


def _strip_snapshot(manifest):
    m = {k: v for k, v in manifest.items() if k not in _MAY_DIFFER["manifest"]}
    extra = json.loads(json.dumps(m["extra"]))
    extra["loop"]["elapsed_s"] = None
    for lvl in extra["loop"]["per_level"].values():
        lvl.pop("wall_s", None)
    match = extra["fingerprint"]["config"]["match"]
    for key in _MAY_DIFFER["config"]:
        match.pop(key, None)
    m["extra"] = extra
    return m


def test_fault_cut_snapshots_equal_reference(tmp_path, monkeypatch,
                                            reference):
    """The same fault plan cuts both sessions at the same snapshot: every
    committed step agrees leaf by leaf and manifest by manifest (the
    pinned calibration names its file: both read the same one)."""
    _, ref_dir, cal = reference
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(cal))
    faults.install(FaultPlan([FaultSpec("session.snapshot", "crash",
                                        at=_KILL_AT)]))
    with pytest.raises(InjectedCrash):
        _session(_graph(), _ref_cfg(), tmp_path, checkpoint_every=1,
                 keep_last=100, async_saves=False).run()
    faults.clear()
    steps = ckpt.committed_steps(tmp_path)
    assert steps == ckpt.committed_steps(ref_dir) == list(range(_KILL_AT))
    n_leaves = 0
    for s in steps:
        got_d, want_d = (d / f"step_{s:08d}" for d in (tmp_path, ref_dir))
        got = json.loads((got_d / "manifest.json").read_text())
        want = json.loads((want_d / "manifest.json").read_text())
        assert _strip_snapshot(got) == _strip_snapshot(want), s
        for i in range(got["n_leaves"]):
            a = np.load(got_d / f"arr_{i:05d}.npy")
            b = np.load(want_d / f"arr_{i:05d}.npy")
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        n_leaves += got["n_leaves"]
    assert n_leaves > 0, "no in-flight snapshot compared"


# ---------------------------------------------------------------------------
# resume at every snapshot
# ---------------------------------------------------------------------------

_PRICED = {"schema": 3, "dispatch_overhead_s": 0.05, "lane_time_s": 2e-9,
           "row_time_s": 4e-6, "vmap_factor": 1.15,
           "escalation_fraction": 0.25}

RESUME_CASES = {
    # complete=True maximizes block count → most mid-pattern snapshots
    "mis-batched": ("mis", dict(complete=True, execution="batched")),
    # early exit exercises the active-set shrink/re-stack snapshots
    "mis_luby-batched": ("mis_luby", dict(sigma=3, lam=0.5,
                                          execution="batched")),
    "mni-batched": ("mni", dict(sigma=3, lam=0.5, execution="batched")),
    # in-flight MNI and frac tables (updated in place) across many blocks
    "mni-batched-complete": ("mni", dict(complete=True, execution="batched")),
    "frac-batched": ("frac", dict(sigma=2, lam=0.5, execution="batched")),
    # auto priced onto the sampled plane (recorded pricing, draw, rounds)
    # and forced sampled (sample groups, classification, escalation by
    # replay); one level each: every snapshot rewrites the replay rows as
    # JSON, so a second level would multiply the sweep's time (a replanned
    # second level: test_resume_pins_planner_calibration)
    "mis-auto": ("mis", dict(execution="auto", sample_fraction=0.5,
                             max_pattern_size=2,
                             match=MatchConfig(**_SAMPLED_MATCH))),
    "mis-sampled": ("mis", dict(execution="sampled", sample_fraction=0.5,
                                max_pattern_size=2,
                                match=MatchConfig(**_SAMPLED_MATCH))),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_equal_at_every_snapshot(tmp_path, monkeypatch, case):
    metric, kw = RESUME_CASES[case]
    if kw["execution"] == "auto":
        cal = tmp_path / "priced.json"
        cal.write_text(json.dumps(_PRICED))
        monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(cal))
    g, cfg = _graph(), _cfg(metric, **kw)
    ref = mine(g, cfg, device="cpu")
    if kw["execution"] == "auto":
        assert any(st["plan"]["plane"] == "sampled"
                   for st in ref.per_level.values())

    base = _session(g, cfg, tmp_path / "base", checkpoint_every=1,
                    keep_last=100)
    assert _norm(base.run()) == _norm(ref)
    total = base.snapshots_written
    assert total >= 2
    for kill_at in range(1, total + 1):
        d = tmp_path / f"kill{kill_at}"
        fired = _killed_session(g, cfg, d, kill_at, checkpoint_every=1,
                                keep_last=100)
        assert fired, f"bomb at snapshot {kill_at} never fired"
        resumed = _session(g, cfg, d, checkpoint_every=1,
                           keep_last=100).run()
        assert _norm(resumed) == _norm(ref), f"kill_at={kill_at}"


def test_resume_survives_crash_during_save(tmp_path, monkeypatch):
    """A kill inside the checkpoint write (tmp written, COMMIT not) falls
    back to the previous committed snapshot and still converges."""
    g, cfg = _graph(), _cfg("mis", complete=True, execution="batched")
    ref = mine(g, cfg, device="cpu")
    sess = _session(g, cfg, tmp_path, checkpoint_every=1, keep_last=100,
                    async_saves=False)
    count = [0]
    real_save = ckpt.save

    def crashing_save(root, step, tree, **kwargs):
        count[0] += 1
        if count[0] == 3:  # third snapshot: die mid-write
            tmp = Path(root) / f"step_{step:08d}.tmp"
            tmp.mkdir(parents=True, exist_ok=True)
            (tmp / "manifest.json").write_text("{\"half\": true}")
            raise Boom()
        return real_save(root, step, tree, **kwargs)

    monkeypatch.setattr("repro_torch.runtime.session.ckpt.save",
                        crashing_save)
    with pytest.raises(Boom):
        sess.run()
    monkeypatch.undo()
    assert ckpt.latest_step(tmp_path) is not None
    resumed = _session(g, cfg, tmp_path, checkpoint_every=1,
                       keep_last=100).run()
    assert _norm(resumed) == _norm(ref)


def test_coarse_checkpoint_cadence(tmp_path):
    g, cfg = _graph(), _cfg("mis", complete=True, execution="batched")
    ref = mine(g, cfg, device="cpu")
    assert _killed_session(g, cfg, tmp_path, 2, checkpoint_every=3,
                           keep_last=100)
    resumed = _session(g, cfg, tmp_path, checkpoint_every=3,
                       keep_last=100).run()
    assert _norm(resumed) == _norm(ref)


# ---------------------------------------------------------------------------
# refusals, modes, pinned calibration
# ---------------------------------------------------------------------------

def test_resume_modes(tmp_path):
    g, cfg = _graph(), _cfg("mis")
    with pytest.raises(FileNotFoundError):
        _session(g, cfg, tmp_path / "empty", resume="must").run()
    _session(g, cfg, tmp_path, checkpoint_every=0).run()
    assert load_session(tmp_path, cfg, device="cpu") is not None
    fresh = _session(g, cfg, tmp_path, resume="never")
    fresh.run()
    assert fresh.snapshots_written >= 1
    with pytest.raises(ValueError):
        _session(g, cfg, tmp_path, resume="sometimes")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MiningSession(g, cfg, tmp_path)   # the device defaults to cuda


def test_fingerprint_and_sample_knob_refusals(tmp_path):
    g = _graph()
    sampled = dict(execution="sampled", sample_fraction=0.5,
                   match=MatchConfig(**_SAMPLED_MATCH))
    _session(g, _cfg("mis", **sampled), tmp_path, checkpoint_every=0).run()
    for change in (dict(sigma=7), dict(sample_fraction=0.75),
                   dict(sample_seed=1), dict(confidence=0.9)):
        with pytest.raises(SessionMismatch):
            _session(g, _cfg("mis", **dict(sampled, **change)),
                     tmp_path).run()
    g2 = rmat_graph(64, 320, n_labels=2, seed=4, undirected=True)
    with pytest.raises(SessionMismatch):
        _session(g2, _cfg("mis", **sampled), tmp_path).run()
    # unchanged knobs resume (a finished run re-materializes); the time
    # limit is not part of the identity
    again = _session(g, _cfg("mis", time_limit_s=99.0, **sampled), tmp_path)
    again.run()
    assert again.snapshots_written == 0


def test_fingerprint_differs_from_reference_only_in_jax_fields():
    jg = j_rmat(64, 320, n_labels=2, seed=3, undirected=True)
    jcfg = JMiningConfig(sigma=6, lam=1.0, metric="mis", max_pattern_size=3,
                         match=JMatchConfig(**_MATCH))
    from repro.runtime import session_fingerprint as j_fingerprint

    want = json.loads(json.dumps(j_fingerprint(jg, jcfg)))
    got = json.loads(json.dumps(session_fingerprint(_graph(), _cfg("mis"))))
    for key in _MAY_DIFFER["config"]:
        want["config"]["match"].pop(key)
    assert got == want


def test_resume_pins_planner_calibration(tmp_path, monkeypatch):
    """A resumed session replans with the cost model the run started with,
    even if the calibration file changed between processes."""
    # the run starts with the reference's CPU fit, under which this tiny
    # level plans sequential
    start = tmp_path / "start.json"
    start.write_text((REPO / "planner_calibration.json").read_text())
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(start))
    g, cfg = _graph(), _cfg("mis", complete=True)
    ref = mine(g, cfg, device="cpu")
    # kill right after the level-1 boundary snapshot, so the resumed
    # process must replan level 2 itself
    assert _killed_session(g, cfg, tmp_path, 1, checkpoint_every=0,
                           keep_last=100)
    crazy = tmp_path / "crazy_calibration.json"
    crazy.write_text(json.dumps({
        "schema": 1, "dispatch_overhead_s": 100.0,
        "lane_time_s": 1e-15, "row_time_s": 1e-15, "vmap_factor": 1.0}))
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(crazy))
    fresh = mine(g, cfg, device="cpu")
    assert any(st["plan"]["plane"] == "batched"
               for st in fresh.per_level.values())
    assert _norm(fresh) != _norm(ref)
    resumed = _session(g, cfg, tmp_path, checkpoint_every=1,
                       keep_last=100).run()
    assert _norm(resumed) == _norm(ref)


# ---------------------------------------------------------------------------
# the CLI: SIGTERM → exit 75 → rerun equals the reference CLI
# ---------------------------------------------------------------------------

# one level (the reference CLI compiles a program per bucket shape; level
# 1's eight root blocks give the session in-flight snapshots)
CLI_FLAGS = ["--dataset", "gnutella", "--scale", "0.02", "--sigma", "10",
             "--lam", "0.6", "--max-size", "2", "--cap", "4096",
             "--root-block", "16", "--execution", "batched"]


def _strip_cli(path):
    d = json.loads(Path(path).read_text())
    d.pop("elapsed_s", None)
    d.pop("health", None)  # a resumed run records recoveries; oracle never
    for lvl in d.get("per_level", {}).values():
        lvl.pop("wall_s", None)
    return d


def test_cli_sigterm_preempts_resumably(tmp_path):
    assert t_cli.EXIT_PREEMPTED == j_cli.EXIT_PREEMPTED == EXIT_PREEMPTED
    want = tmp_path / "ref.json"
    assert j_cli.main(CLI_FLAGS + ["--json", str(want)]) == 0

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ckpt_dir, out = tmp_path / "ckpt", tmp_path / "out.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.mine", "--device",
           "cpu", *CLI_FLAGS, "--json", str(out), "--checkpoint-dir",
           str(ckpt_dir), "--checkpoint-every", "1"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO)
    # the handlers are in place before the graph loads: a signal sent once
    # the load line is out stops the run at its first snapshot
    head = []
    for line in proc.stdout:
        head.append(line)
        if "|V|=" in line:
            break
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    output = "".join(head) + proc.communicate(timeout=120)[0]
    # caught mid-run (preempted, resumable) or finished before the signal
    assert proc.returncode in (0, EXIT_PREEMPTED), output
    if proc.returncode == EXIT_PREEMPTED:
        assert "preempted" in output, output
        assert list(ckpt_dir.glob("step_*/COMMIT"))
        assert not out.exists()
        assert not list(ckpt_dir.glob("step_*.tmp"))

    r2 = subprocess.run(cmd + ["--resume"], env=env, capture_output=True,
                        text=True, timeout=120, cwd=REPO)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "snapshots written" in r2.stdout
    assert _strip_cli(out) == _strip_cli(want)


def test_cli_resume_requires_checkpoint_dir(capsys):
    with pytest.raises(SystemExit):
        t_cli.main(["--device", "cpu", "--resume"])
    assert "--resume requires --checkpoint-dir" in capsys.readouterr().err
