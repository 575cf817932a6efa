"""The port's GraphSAGE forward and its sampler against the JAX reference,
on the CPU.

On CPU tensors the gather-aggregate wrapper takes its plain version, so
these tests hold the port's algorithm to the reference's on the same numpy
inputs, with the reference's weights carried over by `repro_torch.interop`:

  * `ops.gather_aggregate` against the reference's oracle and its Pallas
    kernel in interpret mode on ``tests/kernels/test_kernels.py``'s cases
    (f32, atol = rtol = 1e-5), and against the reference's segment-sum
    message passing; `pad_adjacency` equal to the reference's;
  * the padded in-neighbour table path (`in_neighbor_table` +
    `gather_aggregate`) against the reference's ``gather`` +
    ``scatter_mean`` on f32 features: 1e-6, f32 summation order;
  * `sage_apply` / `sage_loss` at the reduced config and on a sampled
    block: the reference's bf16 scatter rounds after every add, the port
    sums in f32 and rounds once, so logits are held to the reference's
    bf16 kernel tolerance (atol = rtol = 2e-2) and the loss to 1e-3
    relative;
  * `NeighborSampler` blocks bit-exact against ``repro.data.sampler``;
  * the arch wrapper: shapes and input specs equal, unported shapes and the
    training step raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn_arch as j_gnn_arch
from repro.configs import graphsage_reddit as j_sage_cfg
from repro.core import build_graph as j_build_graph
from repro.data.sampler import NeighborSampler as JSampler
from repro.data.synthetic import rmat_graph as j_rmat
from repro.kernels.gather_aggregate.kernel import gather_aggregate_pallas
from repro.kernels.gather_aggregate.ops import pad_adjacency as j_pad
from repro.kernels.gather_aggregate.ref import gather_aggregate_ref as j_agg_ref
from repro.models.gnn import common as j_common
from repro.models.gnn import graphsage as j_sage

from repro_torch import interop
from repro_torch.configs import gnn_arch as t_gnn_arch
from repro_torch.configs.registry import get_arch
from repro_torch.data.sampler import NeighborSampler as TSampler
from repro_torch.data.sampler import block_graph_batch
from repro_torch.data.synthetic import rmat_graph as t_rmat
from repro_torch.data.synthetic import rmat_undirected_graph
from repro_torch.kernels.gather_aggregate.ops import (
    gather_aggregate, in_neighbor_table, pad_adjacency,
)
from repro_torch.models.gnn import common as t_common
from repro_torch.models.gnn.graphsage import SAGEConfig, sage_apply, sage_loss


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("N,F,Dmax", [(64, 16, 5), (128, 32, 8), (32, 8, 1),
                                      (256, 64, 16)])
@pytest.mark.parametrize("mean", [False, True])
def test_gather_aggregate_matches_reference_kernel(N, F, Dmax, mean):
    rng = np.random.default_rng(N + F)
    feats = rng.normal(size=(N, F)).astype(np.float32)
    nbrs = rng.integers(-1, N, (N, Dmax)).astype(np.int32)
    got = _np(gather_aggregate(torch.as_tensor(feats), torch.as_tensor(nbrs),
                               mean=mean))
    for want in (j_agg_ref(jnp.asarray(feats), jnp.asarray(nbrs), mean=mean),
                 gather_aggregate_pallas(jnp.asarray(feats), jnp.asarray(nbrs),
                                         mean=mean, block_nodes=32,
                                         interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def _random_graph(n=64, p=0.1, seed=3):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < p
    np.fill_diagonal(m, False)
    src, dst = np.nonzero(m)
    return rng, j_build_graph(n, np.stack([src, dst], 1), np.zeros(n, np.int32))


def test_gather_aggregate_matches_segment_sum_path():
    rng, g = _random_graph()
    n = g.n
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    d_max = int(g.max_in_degree)
    nbrs = pad_adjacency(g.in_indptr, g.in_indices, d_max)
    np.testing.assert_array_equal(nbrs, j_pad(g.in_indptr, g.in_indices, d_max))
    np.testing.assert_array_equal(
        pad_adjacency(g.in_indptr, g.in_indices, 2),
        j_pad(g.in_indptr, g.in_indices, 2))               # degree-capped
    got = _np(gather_aggregate(torch.as_tensor(feats), torch.as_tensor(nbrs)))
    src = np.repeat(np.arange(n), np.diff(g.out_indptr))
    dst = g.out_indices
    want = j_common.scatter_sum(jnp.asarray(feats)[src], jnp.asarray(dst),
                                jnp.ones(dst.shape[0], bool), n)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_in_neighbor_table_rows_hold_sources_in_edge_order():
    rng = np.random.default_rng(4)
    n, e = 40, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    table = in_neighbor_table(torch.as_tensor(src), torch.as_tensor(dst),
                              torch.as_tensor(mask), n).numpy()
    deg = np.bincount(dst[mask], minlength=n)
    assert table.shape == (n, deg.max()) and table.dtype == np.int32
    for v in range(n):
        want = src[mask & (dst == v)]
        np.testing.assert_array_equal(table[v, :want.size], want)
        assert (table[v, want.size:] == -1).all()
    # no valid edge: one column of pads
    none = in_neighbor_table(torch.as_tensor(src), torch.as_tensor(dst),
                             torch.zeros(e, dtype=torch.bool), n)
    assert none.shape == (n, 1) and (none == -1).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_padded_table_path_equals_scatter_mean_path(seed):
    # the algorithm sage_apply runs, in f32: one table per batch, then the
    # masked neighbour mean, against the reference's gather + scatter_mean
    rng = np.random.default_rng(seed)
    n, e, F = 100, 700, 12
    h = rng.normal(size=(n, F)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    want = j_common.scatter_mean(j_common.gather(jnp.asarray(h),
                                                 jnp.asarray(src)),
                                 jnp.asarray(dst), jnp.asarray(mask), n)
    nbrs = in_neighbor_table(torch.as_tensor(src), torch.as_tensor(dst),
                             torch.as_tensor(mask), n)
    got = gather_aggregate(torch.as_tensor(h), nbrs, mean=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-6)
    # and the port's own scatter_mean, as the reference's
    got2 = t_common.scatter_mean(t_common.gather(torch.as_tensor(h),
                                                 torch.as_tensor(src)),
                                 torch.as_tensor(dst), torch.as_tensor(mask), n)
    np.testing.assert_allclose(_np(got2), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_segment_pool_and_losses_match_reference():
    rng = np.random.default_rng(6)
    N, F, G = 30, 5, 4
    feat = rng.normal(size=(N, F)).astype(np.float32)
    gids = np.sort(rng.integers(0, G, N)).astype(np.int32)
    nmask = rng.random(N) < 0.8
    for mean in (False, True):
        want = j_common.segment_pool(jnp.asarray(feat), jnp.asarray(gids),
                                     jnp.asarray(nmask), G, mean=mean)
        got = t_common.segment_pool(torch.as_tensor(feat),
                                    torch.as_tensor(gids),
                                    torch.as_tensor(nmask), G, mean=mean)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    tgt = rng.integers(0, F, N).astype(np.int32)
    want = float(j_common.node_class_loss(jnp.asarray(feat), jnp.asarray(tgt),
                                          jnp.asarray(nmask)))
    got = float(t_common.node_class_loss(torch.as_tensor(feat),
                                         torch.as_tensor(tgt),
                                         torch.as_tensor(nmask)))
    assert got == pytest.approx(want, rel=1e-6)
    y = rng.normal(size=N).astype(np.float32)
    want = float(j_common.graph_regression_loss(jnp.asarray(feat[:, 0]),
                                                jnp.asarray(y)))
    got = float(t_common.graph_regression_loss(torch.as_tensor(feat[:, 0]),
                                               torch.as_tensor(y)))
    assert got == pytest.approx(want, rel=1e-6)


def _sage_pair(reduced=True, seed=1):
    j_arch, t_arch = j_sage_cfg.ARCH, get_arch("graphsage-reddit")
    jcfg, init, jloss = j_arch._build("minibatch_lg", reduced)
    params = init(jax.random.key(seed))
    tcfg = t_arch.config("minibatch_lg", reduced)
    want = dataclasses.asdict(jcfg)
    assert want.pop("graph_level") is False   # node-level: the port's only kind
    assert dataclasses.asdict(tcfg) == want
    model = interop.sage_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, params, jloss, model


def _assert_logits_close(got: torch.Tensor, want) -> None:
    # the reference's bf16 kernel tolerance: its scatter rounds after each
    # of up to 15 adds, which moves a logit by a few bf16 units
    np.testing.assert_allclose(_np(got), np.asarray(want).astype(np.float32),
                               atol=2e-2, rtol=2e-2)


def test_sage_reduced_matches_reference():
    jcfg, params, jloss, model = _sage_pair()
    gb_j = j_sage_cfg.ARCH.reduced_inputs("minibatch_lg", None)["batch"]
    gb_t = get_arch("graphsage-reddit").reduced_inputs("minibatch_lg",
                                                      device="cpu")
    for f in ("x", "edge_src", "edge_dst", "edge_mask", "node_mask",
              "graph_ids", "targets"):
        np.testing.assert_array_equal(getattr(gb_t, f).numpy(),
                                      np.asarray(getattr(gb_j, f)))
    _assert_logits_close(sage_apply(model, gb_t),
                         j_sage.sage_apply(params, jcfg, gb_j))
    want = float(jloss(params, gb_j))
    got = float(get_arch("graphsage-reddit").loss_fn(
        "minibatch_lg", reduced=True)(model, gb_t))
    assert got == pytest.approx(want, rel=1e-3)
    # the reference's GraphBatch through interop gives the same batch
    gb_i = interop.graph_batch_from_numpy(gb_j)
    assert float(sage_loss(model, gb_i)) == got


def _graph_pair(n, m, seed):
    jg = j_rmat(n, m, n_labels=2, seed=seed, undirected=True)
    tg = t_rmat(n, m, n_labels=2, seed=seed, undirected=True)
    for f in ("out_indptr", "out_indices", "in_indptr", "in_indices",
              "edge_keys", "labels"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    return jg, tg


@pytest.mark.parametrize("fanout,batch,seed", [((5, 3), 32, 0), ((4,), 16, 1),
                                               ((15, 10), 64, 2)])
def test_sampler_blocks_equal_reference(fanout, batch, seed):
    jg, tg = _graph_pair(500, 6000, seed=seed)
    js = JSampler(jg, fanout=fanout, batch_nodes=batch, seed=seed)
    ts = TSampler(tg, fanout=fanout, batch_nodes=batch, seed=seed)
    assert (ts.node_cap, ts.edge_cap) == (js.node_cap, js.edge_cap)
    for step in (0, 1, 7):
        want, got = js.sample(step), ts.sample(step)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name


def test_sage_on_a_sampled_block_matches_reference():
    # a minibatch_lg-shaped block (fanout 15-10) at a small graph and width
    jg, tg = _graph_pair(400, 8000, seed=3)
    blk = TSampler(tg, fanout=(15, 10), batch_nodes=16, seed=0).sample(0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(tg.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, tg.n).astype(np.int32)
    gb_t = block_graph_batch(blk, torch.as_tensor(feats),
                             torch.as_tensor(labels))
    assert gb_t.x.shape == (blk.node_ids.shape[0], 24)
    gb_j = j_common.GraphBatch(
        x=jnp.asarray(feats[blk.x_rows]), edge_src=jnp.asarray(blk.edge_src),
        edge_dst=jnp.asarray(blk.edge_dst), edge_mask=jnp.asarray(blk.edge_mask),
        node_mask=jnp.asarray(blk.node_mask),
        graph_ids=jnp.zeros(blk.node_ids.shape[0], jnp.int32), n_graphs=1,
        targets=jnp.asarray(labels[blk.x_rows]))
    jcfg = j_sage.SAGEConfig(d_in=24, d_hidden=16, n_classes=5)
    params = j_sage.sage_init(jax.random.key(2), jcfg)
    model = interop.sage_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        SAGEConfig(d_in=24, d_hidden=16, n_classes=5))
    _assert_logits_close(sage_apply(model, gb_t),
                         j_sage.sage_apply(params, jcfg, gb_j))
    assert float(sage_loss(model, gb_t)) == pytest.approx(
        float(j_sage.sage_loss(params, jcfg, gb_j)), rel=1e-3)


@pytest.mark.parametrize("shape", list(j_gnn_arch.GNN_SHAPES))
def test_shapes_and_specs_equal_reference(shape):
    j_arch, t_arch = j_sage_cfg.ARCH, get_arch("graphsage-reddit")
    assert dataclasses.asdict(t_gnn_arch.GNN_SHAPES[shape]) == \
        dataclasses.asdict(j_gnn_arch.GNN_SHAPES[shape])
    if shape not in t_gnn_arch.PORTED_SHAPES:
        for call in (t_arch.loss_fn, t_arch.input_specs,
                     t_arch.reduced_inputs):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                call(shape)
    else:
        for reduced in (False, True):
            want = j_arch.input_specs(shape, reduced=reduced)["batch"]
            got = t_arch.input_specs(shape, reduced=reduced)
            assert set(got) == {f.name for f in dataclasses.fields(want)
                                if getattr(want, f.name) is not None
                                and f.name != "n_graphs"}
            for k, spec in got.items():
                w = getattr(want, k)
                assert spec.shape == w.shape, k
                assert str(spec.dtype)[6:] == str(w.dtype), k
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_arch.step_fn(shape)


def test_minibatch_sampler_caps_match_the_shape():
    arch = get_arch("graphsage-reddit")
    meta = arch.meta("minibatch_lg")
    jg, tg = _graph_pair(300, 3000, seed=4)
    s = arch.sampler(tg)
    assert (s.fanout, s.batch) == (meta["fanout"], meta["seeds"])
    assert (s.node_cap, s.edge_cap) == (meta["n_nodes"], meta["n_edges"])
    x, y = arch.node_data("minibatch_lg", 50, seed=0, device="cpu")
    assert x.shape == (50, 602) and x.dtype == torch.float32
    assert y.dtype == torch.int32 and 0 <= int(y.min()) and int(y.max()) < 41


@pytest.mark.parametrize("n,n_edges,seed", [(2000, 20_000, 0),
                                            (232_965, 60_000, 3)])
def test_rmat_undirected_graph_has_the_exact_edge_count(n, n_edges, seed):
    g = rmat_undirected_graph(n, n_edges, seed=seed)
    assert g.n == n and g.n_edges == n_edges
    src = np.repeat(np.arange(n), np.diff(g.out_indptr))
    dst = g.out_indices.astype(np.int64)
    assert (src != dst).all()
    keys = src * n + dst
    assert np.array_equal(np.sort(dst * n + src), keys)   # symmetric
    assert np.unique(keys).size == keys.size               # no duplicates
    again = rmat_undirected_graph(n, n_edges, seed=seed)
    assert np.array_equal(again.edge_keys, g.edge_keys)
    with pytest.raises(ValueError, match="even"):
        rmat_undirected_graph(n, n_edges + 1, seed=seed)


def test_minibatch_graph_has_the_requested_edges():
    g = get_arch("graphsage-reddit").graph("minibatch_lg", n_edges=40_000)
    assert (g.n, g.n_edges) == (232_965, 40_000)
