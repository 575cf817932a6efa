"""The port's distributed mining plane against the reference's, on the CPU.

The reference runs once for the test session, in subprocesses with four
forced host devices and meshes over the first 1, 2 and 4 of them
(``mining_mesh(devices=jax.devices()[:m])``), one a mesh size.  The port runs once per world
size 1, 2 and 4: one ``torch.multiprocessing.start_processes`` of gloo
ranks each (forked from a server that imported the port once), joined
through a ``file://`` store in the test's temporary directory (no
TCP port to clash between test workers).  Both compute, on the geometry of
the reference's distributed tests (``rmat_graph(200, 1200)``, cap 2 048,
root block 32):

* ``distributed_support`` of 4 patterns, complete and at τ 3;
* ``distributed_batched_supports`` of 6 patterns, complete (with the final
  bitmaps) and at half the complete supports;
* every `SuperBlockState` that ``iter_batched_supports`` yields at
  ``blocks_per_super`` 3, complete and at half τ;
* ``mine(execution="distributed")`` on the reference's cross-mesh session
  config (``rmat_graph(100, 600)``, ``blocks_per_super`` 3).

Each world size must equal the reference at the same mesh size, bit for
bit (bitmaps compared as uint32 words), and ``mine`` must equal the
reference's result (``dispatches`` at world size 4 too, the reference's
mesh there).  Every rank returns the same.  A session killed after its
third snapshot at world size 2 — with a super-block cursor in flight —
resumes at world sizes 1 and 4 to the uninterrupted result except
``wall_s`` and ``dispatches``.  A mesh of one without a process group
equals world size 1.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.testing.shared import shared_result

REPO = Path(__file__).resolve().parents[1]
WORLD_SIZES = (1, 2, 4)
KILL_AT = 3          # the session snapshot after which the ranks crash

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax
    from repro.core import MatchConfig, MiningConfig, initial_candidates, mine
    from repro.core import distributed as D
    from repro.data.synthetic import rmat_graph

    g = rmat_graph(200, 1200, n_labels=2, seed=3, undirected=True)
    cfg = MatchConfig.for_graph(g, cap=2048, root_block=32)
    pats = initial_candidates(g)
    part, path = sys.argv[1:3]
    out = {}
    for m in [int(part)] if part != "mine" else []:
        mesh = D.mining_mesh(devices=jax.devices()[:m])
        r = {}
        r["support"] = [list(D.distributed_support(
            g, p, 10**6, mesh=mesh, match_cfg=cfg, complete=True))
            for p in pats[:4]]
        r["support_tau3"] = [list(D.distributed_support(
            g, p, 3, mesh=mesh, match_cfg=cfg)) for p in pats[:4]]
        sup, found, st = D.distributed_batched_supports(
            g, pats[:6], [10**6] * 6, mesh=mesh, match_cfg=cfg,
            complete=True, return_state=True)
        r["batched"] = [sup.tolist(), found.tolist(),
                        np.asarray(st.bitmaps, np.uint32).tolist()]
        half = [max(1, int(s) // 2) for s in sup]
        sup2, found2 = D.distributed_batched_supports(
            g, pats[:6], half, mesh=mesh, match_cfg=cfg)
        r["batched_half"] = [sup2.tolist(), found2.tolist()]
        r["states"] = [
            {"next_block": s.next_block,
             "counts": np.asarray(s.counts).tolist(),
             "bitmaps": np.asarray(s.bitmaps, np.uint32).tolist(),
             "found": s.found.tolist(), "overflowed": s.overflowed.tolist(),
             "blocks_run": s.blocks_run.tolist(),
             "super_blocks_run": s.super_blocks_run,
             "dispatches": s.dispatches, "max_count": s.max_count.tolist()}
            for complete in (True, False)
            for s in D.iter_batched_supports(
                g, pats[:6], [10**6] * 6 if complete else half, mesh=mesh,
                match_cfg=cfg, complete=complete, blocks_per_super=3)]
        out[str(m)] = r
    if part == "mine":
        gm = rmat_graph(100, 600, n_labels=2, seed=3, undirected=True)
        res = mine(gm, MiningConfig(
            sigma=3, lam=0.5, metric="mis_luby", max_pattern_size=3,
            execution="distributed", blocks_per_super=3,
            match=MatchConfig(cap=1024, root_block=16, chunk=16,
                              max_chunks=6, bisect_iters=8)))
        out["mine"] = {
            "frequent": [[p.labels.tolist(), p.edges(), int(s)]
                         for p, s in res.frequent],
            "searched": res.searched,
            "stats": [[st.pattern.labels.tolist(), st.pattern.edges(),
                       st.support, st.tau, st.frequent, st.embeddings_found,
                       st.overflowed, st.blocks_run, st.max_count]
                      for st in res.stats],
            "per_level": {str(k): {kk: vv for kk, vv in v.items()
                                   if kk != "wall_s"}
                          for k, v in res.per_level.items()},
            "timed_out": res.timed_out, "peak": res.peak_device_bytes}
    json.dump(out, open(path, "w"))
""")
REFERENCE_PARTS = ("1", "2", "4", "mine")   # one subprocess each
FORKSERVER_PRELOAD = [
    "torch", "torch.distributed", "repro_torch.core",
    "repro_torch.core.distributed", "repro_torch.data.synthetic",
    "repro_torch.interop", "repro_torch.runtime", "repro_torch.train",
    "test_torch_distributed"]


def _mine_cfg():
    from repro_torch.core import MatchConfig, MiningConfig

    return MiningConfig(
        sigma=3, lam=0.5, metric="mis_luby", max_pattern_size=3,
        execution="distributed", blocks_per_super=3,
        match=MatchConfig(cap=1024, root_block=16, chunk=16, max_chunks=6,
                          bisect_iters=8))


def _result_json(res) -> dict:
    return {
        "frequent": [[p.labels.tolist(), p.edges(), int(s)]
                     for p, s in res.frequent],
        "searched": res.searched,
        "stats": [[st.pattern.labels.tolist(), st.pattern.edges(),
                   st.support, st.tau, st.frequent, st.embeddings_found,
                   st.overflowed, st.blocks_run, st.max_count]
                  for st in res.stats],
        "per_level": {str(k): {kk: vv for kk, vv in v.items()
                               if kk != "wall_s"}
                      for k, v in res.per_level.items()},
        "timed_out": res.timed_out, "peak": res.peak_device_bytes}


def _compute(mesh) -> dict:
    """What the reference script computes at one mesh size, on the port."""
    from repro_torch.core import MatchConfig, initial_candidates, mine
    from repro_torch.core import distributed as D
    from repro_torch.data.synthetic import rmat_graph
    from repro_torch.interop import bitmap_to_uint32

    g = rmat_graph(200, 1200, n_labels=2, seed=3, undirected=True)
    cfg = MatchConfig.for_graph(g, cap=2048, root_block=32)
    pats = initial_candidates(g)
    kw = dict(mesh=mesh, match_cfg=cfg)
    r = {}
    r["support"] = [list(D.distributed_support(g, p, 10**6, complete=True,
                                               **kw)) for p in pats[:4]]
    r["support_tau3"] = [list(D.distributed_support(g, p, 3, **kw))
                         for p in pats[:4]]
    sup, found, st = D.distributed_batched_supports(
        g, pats[:6], [10**6] * 6, complete=True, return_state=True, **kw)
    r["batched"] = [sup.tolist(), found.tolist(),
                    bitmap_to_uint32(st.bitmaps).tolist()]
    half = [max(1, int(s) // 2) for s in sup]
    sup2, found2 = D.distributed_batched_supports(g, pats[:6], half, **kw)
    r["batched_half"] = [sup2.tolist(), found2.tolist()]
    r["states"] = [
        {"next_block": s.next_block, "counts": s.counts.tolist(),
         "bitmaps": bitmap_to_uint32(s.bitmaps).tolist(),
         "found": s.found.tolist(), "overflowed": s.overflowed.tolist(),
         "blocks_run": s.blocks_run.tolist(),
         "super_blocks_run": s.super_blocks_run,
         "dispatches": s.dispatches, "max_count": s.max_count.tolist()}
        for complete in (True, False)
        for s in D.iter_batched_supports(
            g, pats[:6], [10**6] * 6 if complete else half,
            complete=complete, blocks_per_super=3, **kw)]
    gm = rmat_graph(100, 600, n_labels=2, seed=3, undirected=True)
    r["mine"] = _result_json(mine(gm, _mine_cfg(), device="cpu"))
    return r


def _session_graph():
    from repro_torch.data.synthetic import rmat_graph

    return rmat_graph(100, 600, n_labels=2, seed=3, undirected=True)


def _wait_for(path: Path, timeout_s: float = 600.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


def _rank(rank: int, ws: int, tmp: str) -> None:
    """One gloo rank of a world of ``ws``: everything `_compute` does, the
    bit-31 sum, and the session cut (world size 2) or its resume."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{ws}",
                            rank=rank, world_size=ws)
    from repro_torch.core.distributed import mining_mesh
    from repro_torch.runtime import (
        FaultPlan, FaultSpec, InjectedCrash, MiningSession, faults,
        load_session,
    )
    from repro_torch.train import checkpoint as ckpt

    out = _compute(mining_mesh("cpu"))
    # bitmap words are int32: disjoint bit-31 addends must sum to their OR
    t = torch.tensor([-2**31 if rank == 0 else 1], dtype=torch.int32)
    dist.all_reduce(t)
    out["bit31"] = int(t)
    cfg = _mine_cfg()
    if ws == 2:
        faults.install(FaultPlan([FaultSpec("session.snapshot", "crash",
                                            at=KILL_AT)]))
        try:
            MiningSession(_session_graph(), cfg, tmp / "killed",
                          device="cpu", checkpoint_every=1,
                          keep_last=100).run()
        except InjectedCrash:
            ckpt.wait_pending(raise_errors=False)
            out["killed"] = True
        finally:
            faults.clear()
        dist.barrier()                # rank 0's last write has landed
        state, step = load_session(tmp / "killed", cfg, device="cpu")
        cur = state.cursor
        out["cut"] = {"step": step,
                      "plane": (None if cur is None
                                or cur.inflight_super is None
                                else "distributed")}
    else:
        d = tmp / f"resumed{ws}"
        if rank == 0:
            _wait_for(tmp / "ws2_rank0.json")     # world size 2's cut
            shutil.copytree(tmp / "killed", d)
        dist.barrier()
        res = MiningSession(_session_graph(), cfg, d, device="cpu",
                            checkpoint_every=1, keep_last=100,
                            resume="must").run()
        out["resumed"] = _result_json(res)
    (tmp / f"ws{ws}_rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference by mesh size, port by world size → list of rank outputs),
    once for the test session (`shared_result`)."""
    return shared_result(tmp_path_factory, "torch-distributed", _runs)


def _runs(tmp: Path):
    """The reference's subprocesses (one a mesh size, one for ``mine``) run
    while the ranks do.  World size 2 cuts the session that 1 and 4
    resume: all three start together, and 1 and 4 wait for the cut only
    before they resume.  The ranks fork from a server that has imported
    the port once (``forkserver``), not from fresh interpreters."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    mp.set_forkserver_preload(FORKSERVER_PRELOAD)
    logs = [open(tmp / f"ref_{part}.err", "w") for part in REFERENCE_PARTS]
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, part, str(tmp / f"ref_{part}.json")],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=log)
        for part, log in zip(REFERENCE_PARTS, logs)]
    ctxs = []
    try:
        for ws in (2, 1, 4):
            ctxs.append(mp.start_processes(
                _rank, args=(ws, str(tmp)), nprocs=ws, join=False,
                start_method="forkserver"))
        for ctx in ctxs:
            while not ctx.join():
                pass
        for ref in refs:
            ref.wait(timeout=600)
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        for ref, log in zip(refs, logs):
            ref.kill()
            log.close()
    for part, ref in zip(REFERENCE_PARTS, refs):
        assert ref.returncode == 0, \
            (tmp / f"ref_{part}.err").read_text()[-3000:]
    ref = {}
    for part in REFERENCE_PARTS:
        ref.update(json.loads((tmp / f"ref_{part}.json").read_text()))
    port = {ws: [json.loads((tmp / f"ws{ws}_rank{r}.json").read_text())
                 for r in range(ws)] for ws in WORLD_SIZES}
    return ref, port


_FIELDS = ("support", "support_tau3", "batched", "batched_half", "states")


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_supports_and_states_equal_reference(runs, ws):
    ref, port = runs
    for field in _FIELDS:
        assert port[ws][0][field] == ref[str(ws)][field], field


def _no_dispatches(d: dict) -> dict:
    d = json.loads(json.dumps(d))
    for v in d["per_level"].values():
        v.pop("dispatches")
    return d


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_mine_equals_reference(runs, ws):
    ref, port = runs
    got = port[ws][0]["mine"]
    assert _no_dispatches(got) == _no_dispatches(ref["mine"])
    if ws == 4:                       # the reference's mesh: all 4 devices
        assert got == ref["mine"]
    assert got["searched"] > 0 and got["frequent"]


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_every_rank_agrees(runs, ws):
    _, port = runs
    for other in port[ws][1:]:
        assert other == port[ws][0]
    if ws > 1:
        assert port[ws][0]["bit31"] == -2**31 + ws - 1


@pytest.mark.parametrize("ws", [1, 4])
def test_session_cut_at_two_resumes_at(runs, ws):
    ref, port = runs
    cut = port[2][0]
    assert cut["killed"] and cut["cut"]["plane"] == "distributed", cut["cut"]
    got = port[ws][0]["resumed"]
    assert _no_dispatches(got) == _no_dispatches(port[ws][0]["mine"])
    assert _no_dispatches(got) == _no_dispatches(ref["mine"])


def test_mesh_of_one_equals_world_size_one(runs):
    from repro_torch.core.distributed import mining_mesh

    torch.set_num_threads(1)
    assert not dist.is_initialized()
    mesh = mining_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    got = json.loads(json.dumps(_compute(mesh)))
    _, port = runs
    want = {k: v for k, v in port[1][0].items() if k in got}
    assert got == want
