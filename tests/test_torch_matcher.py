"""The port's matcher against the JAX reference, bit for bit, on the CPU.

The port matches a whole same-k bucket at once (leading pattern axis P);
the reference matches one plan per call.  Every one of ``match_block``'s
five outputs must be equal per pattern — embedding rows in order included —
single-phase and two-phase, on directed and undirected graphs, an edgeless
graph, under cap overflow, and for the plain frontier expansion against the
reference's ``frontier_expand_ref`` and its Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MatchConfig as JMatchConfig
from repro.core import build_graph as j_build_graph
from repro.core.flexis import initial_candidates as j_initial
from repro.core.generation import generate_new_patterns as j_generate
from repro.core.graph import DeviceGraph as JDeviceGraph
from repro.core.matcher import edge_exists as j_edge_exists
from repro.core.matcher import match_block as j_match_block
from repro.core.plan import make_plan as j_make_plan
from repro.kernels.frontier_expand.ops import frontier_expand_level as j_pallas
from repro.kernels.frontier_expand.ref import frontier_expand_ref as j_fe_ref

from repro_torch.core import MatchConfig as TMatchConfig
from repro_torch.core import Pattern as TPattern
from repro_torch.core import build_graph as t_build_graph
from repro_torch.core.graph import DeviceGraph as TDeviceGraph
from repro_torch.core.matcher import edge_exists as t_edge_exists
from repro_torch.core.matcher import match_block as t_match_block
from repro_torch.core.plan import make_plan as t_make_plan
from repro_torch.core.plan import stack_plans
from repro_torch.kernels.frontier_expand.ops import frontier_expand_level
from repro_torch.kernels.frontier_expand.ref import frontier_expand_ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _graphs(n, deg, n_labels, seed, undirected=True):
    """The same random graph built by both packages from one numpy draw."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    labels = rng.integers(0, n_labels, n)
    edges = np.stack([src, dst], 1)
    return (j_build_graph(n, edges, labels, undirected=undirected),
            t_build_graph(n, edges, labels, undirected=undirected))


def _cfgs(jg, two_phase, cap=256, root_block=128, chunk=64):
    jc = dataclasses.replace(
        JMatchConfig.for_graph(jg, cap=cap, root_block=root_block, chunk=chunk),
        two_phase=two_phase)
    tc = TMatchConfig(cap=jc.cap, root_block=jc.root_block, chunk=jc.chunk,
                      max_chunks=jc.max_chunks, bisect_iters=jc.bisect_iters,
                      two_phase=two_phase)
    return jc, tc


def _patterns_by_k(jg, max_k=4, per_level=5):
    out = {2: j_initial(jg)[:per_level]}
    for k in range(3, max_k + 1):
        nxt = j_generate(out[k - 1])[:per_level]
        if not nxt:
            break
        out[k] = nxt
    return out


def _port(p):
    return TPattern(p.adj.copy(), p.labels.copy())


def _assert_bucket_equal(jg, tg, pats, jc, tc, block_start):
    """Port's stacked bucket vs the reference, one plan at a time."""
    jdev = JDeviceGraph.from_host(jg)
    tdev = TDeviceGraph.from_host(tg, "cpu")
    plans = stack_plans([t_make_plan(_port(p), tg) for p in pats])
    t_out = t_match_block(tdev, plans, block_start, tc)
    for i, p in enumerate(pats):
        j_out = j_match_block(jdev, j_make_plan(p, jg), jnp.int32(block_start),
                              jc)
        for name, a, b in zip(("emb", "count", "found", "overflowed", "peak"),
                              j_out, t_out):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy(),
                                          err_msg=f"{name} (pattern {i})")
    return t_out


@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("undirected", [True, False])
def test_match_block_equal(two_phase, undirected):
    jg, tg = _graphs(200, 3, 3, seed=1, undirected=undirected)
    jc, tc = _cfgs(jg, two_phase)
    for k, pats in _patterns_by_k(jg, max_k=3).items():
        for bs in (0, jc.root_block):
            _assert_bucket_equal(jg, tg, pats, jc, tc, bs)


@pytest.mark.parametrize("two_phase", [False, True])
def test_match_block_equal_k4(two_phase):
    jg, tg = _graphs(200, 3, 3, seed=1)
    jc, tc = _cfgs(jg, two_phase)
    _assert_bucket_equal(jg, tg, _patterns_by_k(jg, per_level=4)[4], jc, tc, 0)


@pytest.mark.parametrize("two_phase", [False, True])
def test_match_block_multi_chunk(two_phase):
    # chunk 4 below the max degree: survivors pack chunk-major
    jg, tg = _graphs(150, 4, 2, seed=2)
    jc, tc = _cfgs(jg, two_phase, cap=1024, chunk=4)
    assert jc.max_chunks > 1
    for k, pats in _patterns_by_k(jg, max_k=3).items():
        _assert_bucket_equal(jg, tg, pats, jc, tc, 0)


@pytest.mark.parametrize("two_phase", [False, True])
def test_match_block_overflow(two_phase):
    jg, tg = _graphs(200, 6, 1, seed=5)
    jc, tc = _cfgs(jg, two_phase, cap=64, root_block=128)
    saw = False
    for k, pats in _patterns_by_k(jg, max_k=3).items():
        out = _assert_bucket_equal(jg, tg, pats, jc, tc, 0)
        saw |= bool(out[3].any())
    assert saw, "the case must overflow"


def test_match_block_edgeless():
    n = 32
    edges = np.zeros((0, 2), np.int64)
    labels = np.zeros(n, np.int32)
    jg = j_build_graph(n, edges, labels)
    tg = t_build_graph(n, edges, labels)
    jc, tc = _cfgs(jg, False, cap=64, root_block=32)
    from repro.core import Pattern as JPattern
    pat = JPattern(np.array([[False, True], [False, False]]),
                   np.zeros(2, np.int32))
    tdev = TDeviceGraph.from_host(tg, "cpu")
    assert tdev.out_indices.shape == (1,) and tdev.in_indices.shape == (1,)
    _assert_bucket_equal(jg, tg, [pat], jc, tc, 0)


@pytest.mark.parametrize("n_iters", [1, 2, 3, 8])
def test_edge_exists_same_answers(n_iters):
    # few iterations give wrong answers; they must be the same wrong answers
    jg, tg = _graphs(60, 8, 1, seed=9)
    jdev = JDeviceGraph.from_host(jg)
    tdev = TDeviceGraph.from_host(tg, "cpu")
    rng = np.random.default_rng(n_iters)
    u = rng.integers(0, 60, 500).astype(np.int32)
    v = rng.integers(0, 60, 500).astype(np.int32)
    a = j_edge_exists(jdev.out_indptr, jdev.out_indices, jnp.asarray(u),
                      jnp.asarray(v), n_iters)
    b = t_edge_exists(tdev.out_indptr, tdev.out_indices, torch.as_tensor(u),
                      torch.as_tensor(v), n_iters)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _last_level_inputs(jg, tg, pat, jc, tc):
    """Frontier before the last level, from the reference (rows past the
    filled prefix reset to -1), as both packages' tensors."""
    jdev = JDeviceGraph.from_host(jg)
    jp = j_make_plan(pat, jg)
    emb, count, *_ = j_match_block(jdev, jp, jnp.int32(0), jc)
    base = np.asarray(emb).copy()
    base[:, pat.k - 1:] = -1
    tplans = stack_plans([t_make_plan(_port(pat), tg)])
    return (jdev, jp, jnp.asarray(base), count,
            TDeviceGraph.from_host(tg, "cpu"), tplans,
            torch.as_tensor(base)[None], torch.tensor([int(count)],
                                                      dtype=torch.int32))


_j_fe_ref_jit = jax.jit(j_fe_ref, static_argnums=(4, 5))


@pytest.mark.parametrize("seed", [0])
def test_plain_frontier_equals_reference_ref(seed):
    jg, tg = _graphs(80, 3, 2, seed=seed)
    jc, tc = _cfgs(jg, False, cap=64, root_block=64)
    for k, pats in _patterns_by_k(jg, max_k=4, per_level=2).items():
        if k < 3:
            continue
        for pat in pats:
            jdev, jp, jbase, jcount, tdev, tplans, tbase, tcount = \
                _last_level_inputs(jg, tg, pat, jc, tc)
            want = _j_fe_ref_jit(jdev, jp, jbase, jcount, k - 1, jc)
            got = frontier_expand_level(tdev, tplans, tbase, tcount, k - 1, tc)
            also = frontier_expand_ref(tdev, tplans, tbase, tcount, k - 1, tc)
            for a, b, c in zip(want, got, also):
                np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
                assert torch.equal(b, c)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_frontier_equals_pallas_interpret(seed):
    jg, tg = _graphs(60, 3, 2, seed=seed)
    jc, tc = _cfgs(jg, False, cap=64, root_block=64)
    pats = _patterns_by_k(jg, max_k=3, per_level=2)[3]
    for pat in pats:
        jdev, jp, jbase, jcount, tdev, tplans, tbase, tcount = \
            _last_level_inputs(jg, tg, pat, jc, tc)
        want = j_pallas(jdev, jp, jbase, jcount, 2, jc, interpret=True)
        got = frontier_expand_ref(tdev, tplans, tbase, tcount, 2, tc)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
