"""Host modules of the PyTorch port against the JAX reference, on the CPU.

Datasets, candidate generation, canonical keys, matching plans and the
root-block schedule are numpy in both packages; the port keeps its own
copies, so each is checked equal to the reference on the same inputs.
"""
import re

import numpy as np
import pytest
import torch

from repro.core import canonical as jcanon
from repro.core import generation as jgen
from repro.core import planner as jplanner
from repro.core.flexis import initial_candidates as j_initial
from repro.core.plan import make_plan as j_make_plan
from repro.data import synthetic as jsyn

from repro_torch import interop
from repro_torch.core import canonical as tcanon
from repro_torch.core import generation as tgen
from repro_torch.core import planner as tplanner
from repro_torch.core.flexis import initial_candidates as t_initial
from repro_torch.core.graph import build_graph as t_build_graph
from repro_torch.core.pattern import Pattern as TPattern
from repro_torch.core.plan import make_plan as t_make_plan
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import _build

PLAN_FIELDS = ("root_label", "root_min_out", "root_min_in", "anchor_pos",
               "anchor_out", "cand_label", "min_out", "min_in", "check_out",
               "check_in")
GRAPH_ARRAYS = ("labels", "out_indptr", "out_indices", "in_indptr",
                "in_indices", "edge_keys")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _graph_equal(a, b):
    assert (a.n, a.n_labels, a.undirected) == (b.n, b.n_labels, b.undirected)
    for f in GRAPH_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _to_port(p):
    return TPattern(p.adj.copy(), p.labels.copy())


def _keys(pats):
    return [p.key() for p in pats]


@pytest.mark.parametrize("seed,n,m,n_labels,undirected", [
    (0, 50, 120, 3, False), (1, 300, 900, 5, True), (7, 1000, 4000, 29, True),
])
def test_rmat_graph_equal(seed, n, m, n_labels, undirected):
    _graph_equal(
        jsyn.rmat_graph(n, m, n_labels=n_labels, seed=seed,
                        undirected=undirected),
        tsyn.rmat_graph(n, m, n_labels=n_labels, seed=seed,
                        undirected=undirected))


@pytest.mark.parametrize("name", sorted(jsyn.PAPER_DATASETS))
def test_paper_dataset_equal(name):
    assert tsyn.PAPER_DATASETS == jsyn.PAPER_DATASETS
    _graph_equal(jsyn.paper_dataset(name, scale=0.004, seed=3),
                 tsyn.paper_dataset(name, scale=0.004, seed=3))


def test_interop_graph_roundtrip():
    g = jsyn.paper_dataset("gnutella", scale=0.01)
    _graph_equal(g, interop.data_graph_from_arrays(g))


def _graph_pair(seed, n=40, n_labels=3, p=0.12):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < p
    np.fill_diagonal(m, False)
    edges = np.stack(np.nonzero(m), 1)
    labels = rng.integers(0, n_labels, n)
    from repro.core import build_graph as j_build_graph
    return (j_build_graph(n, edges, labels, n_labels=n_labels),
            t_build_graph(n, edges, labels, n_labels=n_labels))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_graph_and_candidates_equal(seed):
    jg, tg = _graph_pair(seed)
    _graph_equal(jg, tg)
    jc, tc = j_initial(jg), t_initial(tg)
    assert _keys(jc) == _keys(tc)
    assert [jcanon.canonical_key(p) for p in jc] == \
        [tcanon.canonical_key(_to_port(p)) for p in jc]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generation_equal(seed):
    jg, tg = _graph_pair(seed, n_labels=2)
    jlevel = j_initial(jg)
    tlevel = [_to_port(p) for p in jlevel]
    for _ in range(2):   # k = 3, then k = 4 from a slice of the k = 3 set
        jnext = jgen.generate_new_patterns(jlevel[:10])
        tnext = tgen.generate_new_patterns(tlevel[:10])
        assert _keys(jnext) == _keys(tnext)
        assert [jcanon.canonical_key(p) for p in jnext] == \
            [tcanon.canonical_key(p) for p in tnext]
        jlevel, tlevel = jnext, tnext
    labels = sorted(set(jg.labels.tolist()))
    jext = jgen.edge_extension_candidates(j_initial(jg)[:6], labels, max_k=4)
    text = tgen.edge_extension_candidates(t_initial(tg)[:6], labels, max_k=4)
    assert _keys(jext) == _keys(text)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_plan_equal(seed):
    jg, tg = _graph_pair(seed)
    pats = j_initial(jg)
    pats += jgen.generate_new_patterns(pats[:8])[:8]
    for p in pats:
        jp, tp = j_make_plan(p, jg), t_make_plan(_to_port(p), tg)
        assert jp.k == tp.k and tuple(jp.order) == tuple(tp.order)
        conv = interop.plan_from_fields(jp)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                          getattr(tp, f).numpy(), err_msg=f)
            assert torch.equal(getattr(conv, f), getattr(tp, f)), f


@pytest.mark.parametrize("root_block,mode", [
    (16, "degree"), (64, "degree"), (128, "vertex"), (100000, "degree"),
])
def test_root_block_order_equal(root_block, mode):
    jg = jsyn.paper_dataset("gnutella", scale=0.05)
    tg = tsyn.paper_dataset("gnutella", scale=0.05)
    np.testing.assert_array_equal(jplanner.block_degree_stat(jg, root_block),
                                  tplanner.block_degree_stat(tg, root_block))
    np.testing.assert_array_equal(
        jplanner.root_block_order(jg, root_block, mode),
        tplanner.root_block_order(tg, root_block, mode))


@pytest.mark.parametrize("source", sorted(_build.SOURCES))
def test_kernel_names_carry_their_source_prefix(source):
    """Every CUDA kernel of a source is named with the source's prefix, and a
    profiler's name of it maps back to that source (device time by kernel)."""
    text = _build.SOURCES[source].read_text()
    names = re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(?:void\s+)?(\w+)\s*\(", text)
    assert names, f"no __global__ function found in {source}"
    for name in names:
        assert name.startswith(_build.KERNEL_PREFIX[source]), name
        key = f"void (anonymous namespace)::{name}<128>(int const*, int)"
        assert _build.kernel_function(key) == name
        assert _build.kernel_source(key) == source
    assert _build.kernel_source(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<int>, std::array<char*, 1ul> >(int, std::array<char*, "
        "1ul>)") is None
