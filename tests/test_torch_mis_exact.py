"""The port's ``mis_exact`` metric and its block-batched collector, on the CPU.

``batched.collect_pattern_embeddings`` stacks one plan over a blocks axis
(per-row block starts in ``matcher._init_roots``, the tail padded with
start n): it equals the one-block-per-call loop and the reference's
collector for any dispatch width.  ``mine(metric="mis_exact")`` equals the
reference's under ``batched``, ``sequential`` and ``auto``; ``sampled``
refuses it in both packages.  The batched plane's scalar block start is
unchanged by the per-row form.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import MatchConfig as JMatchConfig
from repro.core import MiningConfig as JMiningConfig
from repro.core import mine as j_mine
from repro.core import planner as jplanner
from repro.core.batched import collect_pattern_embeddings as j_collect
from repro.core.flexis import _device_bytes as j_device_bytes
from repro.core.flexis import initial_candidates as j_initial
from repro.core.graph import DeviceGraph as JDeviceGraph
from repro.core.plan import make_plan as j_make_plan
from repro.data.synthetic import rmat_graph as j_rmat

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core import planner as tplanner
from repro_torch.core.batched import (
    MIS_EXACT_BLOCKS_PER_DISPATCH, collect_pattern_embeddings,
)
from repro_torch.core.flexis import _device_bytes, initial_candidates
from repro_torch.core.generation import generate_new_patterns
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.matcher import match_block
from repro_torch.core.plan import make_plan, stack_plans
from repro_torch.data.synthetic import rmat_graph


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _calibration(tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(jplanner.CostModel().to_dict()))
    monkeypatch.setenv(jplanner.CALIBRATION_ENV, str(path))
    monkeypatch.setenv(tplanner.CALIBRATION_ENV, str(path))


def _t_match(jc):
    return MatchConfig(cap=jc.cap, root_block=jc.root_block, chunk=jc.chunk,
                       max_chunks=jc.max_chunks, bisect_iters=jc.bisect_iters,
                       two_phase=jc.two_phase)


def _collector_setup():
    g = rmat_graph(150, 900, n_labels=3, seed=8, undirected=True)
    cfg = MatchConfig.for_graph(g, cap=1024, root_block=32)
    n_blocks = -(-g.n // cfg.root_block)
    order = np.random.default_rng(0).permutation(n_blocks).astype(np.int64)
    k2 = initial_candidates(g)
    pats = k2[:2] + generate_new_patterns(k2)[:1]       # k = 2, 2, 3
    return g, cfg, order, pats


def test_collector_equals_per_block_loop():
    """Field for field what the one-block-per-dispatch loop accumulates,
    for any dispatch width (4 of 5 blocks pads the tail)."""
    g, cfg, order, pats = _collector_setup()
    dg = DeviceGraph.from_host(g, "cpu")
    for pat in pats:
        plan = make_plan(pat, g)
        one = stack_plans([plan], "cpu")
        rows, found, ovf, peak = [], 0, False, 0
        for b in order:
            emb, count, f, o, p = match_block(dg, one,
                                              int(b) * cfg.root_block, cfg)
            rows.append(emb[0, :int(count[0])].numpy())
            found += int(f[0])
            ovf |= bool(o[0])
            peak = max(peak, int(p[0]))
        want = np.concatenate(rows, 0)
        assert want.shape[0] > 0
        for width in (1, 2, 4, MIS_EXACT_BLOCKS_PER_DISPATCH):
            embs, f, o, blocks, pk, disp = collect_pattern_embeddings(
                dg, plan, cfg, g.n, block_order=order,
                blocks_per_dispatch=width)
            np.testing.assert_array_equal(embs, want)
            assert embs.dtype == np.int32
            assert (f, o, blocks, pk) == (found, ovf, order.size, peak)
            assert disp == -(-order.size // width)


def test_collector_equals_reference():
    g, cfg, order, pats = _collector_setup()
    jg = j_rmat(150, 900, n_labels=3, seed=8, undirected=True)
    jcfg = JMatchConfig.for_graph(jg, cap=1024, root_block=32)
    assert _t_match(jcfg) == cfg
    jdg, dg = JDeviceGraph.from_host(jg), DeviceGraph.from_host(g, "cpu")
    j_pats = [p for p in j_initial(jg)]
    for pat in pats[:2]:                      # the k = 2 patterns
        jp = next(p for p in j_pats if p.key() == pat.key())
        for width in (3, 8):                  # 8: a padded tail
            got = collect_pattern_embeddings(
                dg, make_plan(pat, g), cfg, g.n, block_order=order,
                blocks_per_dispatch=width)
            want = j_collect(jdg, j_make_plan(jp, jg), jcfg, jg.n,
                             block_order=order, blocks_per_dispatch=width)
            np.testing.assert_array_equal(got[0], np.asarray(want[0]))
            assert got[1:] == tuple(want[1:])


def test_scalar_block_start_unchanged():
    """The batched plane's shared scalar start and a (P,) tensor of it give
    the same tables; per-row starts equal one call per start, and a start
    of n matches nothing."""
    g, cfg, order, pats = _collector_setup()
    dg = DeviceGraph.from_host(g, "cpu")
    k2 = [p for p in pats if p.k == 2]
    bucket = stack_plans([make_plan(p, g) for p in k2], "cpu")
    start = int(order[0]) * cfg.root_block
    a = match_block(dg, bucket, start, cfg)
    b = match_block(dg, bucket, torch.full((len(k2),), start,
                                           dtype=torch.int32), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    plan = make_plan(k2[0], g)
    starts = [int(order[1]) * cfg.root_block, int(order[2]) * cfg.root_block,
              g.n]
    rows = match_block(dg, stack_plans([plan] * 3, "cpu"),
                       torch.tensor(starts, dtype=torch.int32), cfg)
    for j, s in enumerate(starts):
        one = match_block(dg, stack_plans([plan], "cpu"), s, cfg)
        for x, y in zip(rows, one):
            assert torch.equal(x[j], y[0])
    assert int(rows[1][2]) == 0


def _stats(res):
    return dict(
        frequent=[(p.key(), s) for p, s in res.frequent],
        searched=res.searched,
        stats=[(s.pattern.key(), s.support, s.tau, s.frequent,
                s.embeddings_found, s.overflowed, s.blocks_run, s.max_count,
                s.dispatches) for s in res.stats],
        per_level={k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                   for k, v in res.per_level.items()},
        peak=res.peak_device_bytes, timed_out=res.timed_out)


@pytest.mark.parametrize("execution", ("batched", "sequential", "auto"))
def test_mine_mis_exact_equals_reference(execution):
    jg = j_rmat(24, 60, n_labels=4, seed=9, undirected=True)
    g = rmat_graph(24, 60, n_labels=4, seed=9, undirected=True)
    jm = JMatchConfig.for_graph(jg, cap=1024, root_block=32)
    kw = dict(sigma=2, lam=1.0, metric="mis_exact", max_pattern_size=3,
              execution=execution)
    want = j_mine(jg, JMiningConfig(match=jm, **kw))
    got = mine(g, MiningConfig(match=_t_match(jm), **kw), device="cpu")
    assert _stats(got) == _stats(want)
    assert got.frequent and any(st.pattern.k == 3 for st in got.stats)
    if execution == "auto":
        assert all(st["plan"]["plane"] == "sequential"
                   for st in got.per_level.values())


def test_sampled_refuses_mis_exact():
    for cfg_cls in (MiningConfig, JMiningConfig):
        with pytest.raises(ValueError, match="mis_exact"):
            cfg_cls(sigma=2, metric="mis_exact", execution="sampled")


def test_device_bytes_equal_reference():
    jc = JMatchConfig(cap=4096, root_block=64, chunk=16, max_chunks=3)
    for metric in ("mis", "mis_luby", "mni", "frac", "mis_exact"):
        assert _device_bytes(_t_match(jc), metric, 3, 1000) == \
            j_device_bytes(jc, metric, 3, 1000)
