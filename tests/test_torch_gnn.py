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
  * the arch wrapper: shapes and input specs equal on every shape
    (ogb_products included, which GraphSAGE runs over the CSR aggregate);
  * CSR segments (GraphSAGE's aggregate): the plain CSR aggregate equal
    byte for byte to the padded plain version on random tables and on
    stars (one row of 600 ids, the rest 0–3, empty rows included); `in_csr`
    rows equal `in_neighbor_table`'s; the transpose built from the in-CSR
    (`csr_transpose`) replayed against autograd (rtol = atol = 1e-5); the
    GraphSAGE CSR path on a hub graph against the reference's
    ``sage_loss`` (logits 2e-2, loss 1e-3, gradients 0.05·max|g| against
    the reference with its scatter rounded once, as the port's aggregate);
  * ogb_products: the full batch made at a small size (exact counts,
    symmetric, no self-loops, padding masked, 100 features, 47 classes);
    schnet, nequip and graphcast refuse it naming their edge tensor's
    bytes.
"""
import dataclasses
from unittest import mock

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
    csr_transpose, gather_aggregate, gather_aggregate_csr, in_csr,
    in_neighbor_table, out_neighbor_csr, pad_adjacency, padded_to_csr,
)
from repro_torch.kernels.gather_aggregate.kernel import LONG_ROW
from repro_torch.kernels.gather_aggregate.ref import gather_aggregate_t_ref
from repro_torch.models.gnn import common as t_common
from repro_torch.models.gnn.graphsage import SAGEConfig, sage_apply, sage_loss
from repro_torch.testing.parity import (
    AGG_CSR_CASES, agg_csr_case, agg_inputs, agg_star_inputs,
)
from repro_torch.train.step import trainable_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the plain aggregates loop over neighbour positions in small ops,
    # which torch's intra-op threads only slow down beside other workers
    torch.set_num_threads(1)


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
    params = jax.jit(init)(jax.random.key(seed))
    tcfg = t_arch.config("minibatch_lg", reduced)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.graph_level is False
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
    if shape not in t_arch.ported_shapes:
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
    if shape not in t_arch.ported_shapes:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_arch.step_fn(shape)
    else:
        assert callable(t_arch.step_fn(shape))


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


# ---------------------------------------------------------------------------
# CSR segments: GraphSAGE's aggregate since ogb_products (sage_apply builds
# the in-neighbour CSR once a batch, `in_csr`); its plain version adds each
# row's ids in order in f32, as the padded one does, so the two layouts'
# bytes are equal (the card's kernel is held to both: test_torch_gpu.py)
# ---------------------------------------------------------------------------

CSR_CPU_CASES = [c for c in AGG_CSR_CASES if len(c) == 6] + [
    (f"star600-F{F}-{str(dt)[6:]}-{'mean' if mean else 'sum'}", 2048, F, 600,
     dt, mean, "star")
    for dt in (torch.float32, torch.bfloat16)
    for mean, F in ((True, 128), (False, 100))]


@pytest.mark.parametrize("case", CSR_CPU_CASES,
                         ids=[c[0] for c in CSR_CPU_CASES])
def test_csr_plain_equals_padded_plain(case):
    # random tables read as CSR (pads dropped, a third of the rows empty)
    # and stars (one row of 600 ids, the others 0–3): equal bytes
    assert agg_csr_case(case, "cpu") == 0.0


def test_csr_plain_rows_around_long_row_equal_padded_plain():
    # rows of LONG_ROW − 1, LONG_ROW and LONG_ROW + 1 ids among short ones
    # (the card's short and long paths), read as CSR and as the padded
    # table: equal bytes
    case = ("rowsT-F8-bfloat16-mean", 512, 8, LONG_ROW + 1, torch.bfloat16,
            True, "rowsT")
    assert agg_csr_case(case, "cpu") == 0.0


def test_in_csr_rows_equal_the_padded_table():
    rng = np.random.default_rng(8)
    n, e = 60, 500
    src = torch.as_tensor(rng.integers(0, n, e).astype(np.int32))
    dst = torch.as_tensor(np.where(rng.random(e) < 0.4, 3,
                                   rng.integers(0, n, e)).astype(np.int32))
    mask = torch.as_tensor(rng.random(e) < 0.8)
    indptr, csr_src = in_csr(src, dst, mask, n)
    assert indptr.dtype == csr_src.dtype == torch.int32
    assert int(indptr[-1]) == int(mask.sum()) == csr_src.numel()
    table = in_neighbor_table(src, dst, mask, n)
    for v in range(n):
        row = csr_src[indptr[v]:indptr[v + 1]]
        np.testing.assert_array_equal(table[v, :row.numel()].numpy(),
                                      row.numpy())
        assert (table[v, row.numel():] == -1).all()
    assert torch.equal(padded_to_csr(table)[1], csr_src)


@pytest.mark.parametrize("case", [c for c in CSR_CPU_CASES
                                  if c[4] == torch.float32][::4],
                         ids=lambda c: c[0])
def test_csr_transpose_replays_autograd(case):
    # the transpose kernel's input, built from the in-CSR by a stable sort,
    # replayed in plain torch against autograd of the plain CSR aggregate
    name, N, F, Dmax, dtype, mean, *variant = case
    make = agg_star_inputs if variant else agg_inputs
    feats, nbrs = make(N, F, Dmax, dtype, "cpu", seed=9)
    indptr, src = padded_to_csr(nbrs)
    t_indptr, dst, deg = csr_transpose(indptr, src)
    for a, b in zip(out_neighbor_csr(nbrs), (t_indptr, dst, deg)):
        assert torch.equal(a, b)                      # the padded table's
    for u in range(0, N, max(N // 50, 1)):            # destinations ascending
        rows = dst[t_indptr[u]:t_indptr[u + 1]].numpy()
        assert (np.diff(rows) >= 0).all()
    d_out = torch.as_tensor(np.random.default_rng(10).normal(size=(N, F)),
                            dtype=torch.float32)
    got = gather_aggregate_t_ref(d_out, t_indptr, dst, deg if mean else None)
    f = feats.clone().requires_grad_()
    gather_aggregate_csr(f, indptr, src, mean=mean).backward(d_out)
    np.testing.assert_allclose(got.numpy(), f.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def _ref_scatter_mean_once(messages, dst, mask, n_nodes):
    """The reference's ``scatter_mean`` with its sums taken in f32 and
    rounded once, as the port's aggregate does (its bf16 ``.at[].add``
    rounds after every add: ~225 adds into the hub below)."""
    msg = jnp.where(mask[:, None], messages, 0).astype(jnp.float32)
    s = jnp.zeros((n_nodes, messages.shape[-1]), jnp.float32).at[dst].add(msg)
    deg = jnp.zeros((n_nodes,), jnp.float32).at[dst].add(
        mask.astype(jnp.float32))
    return (s / jnp.maximum(deg, 1)[:, None]).astype(messages.dtype)


def test_sage_csr_path_on_a_hub_graph_matches_reference():
    # node 0 takes in-edges from 250 of 300 nodes, the rest ~2 each (some
    # masked): the port's CSR aggregate against the reference's gather +
    # bf16 scatter_mean — logits 2e-2, loss 1e-3 — and its gradients,
    # 0.05·max|g| leaf by leaf, against the reference's with the scatter
    # summed in f32 and rounded once (`_ref_scatter_mean_once`: the hub's
    # ~225 bf16 roundings alone move neigh.0's gradient 0.075·max|g|)
    rng = np.random.default_rng(11)
    n, F = 300, 24
    hub_src = rng.choice(np.arange(1, n), 250, replace=False)
    src = np.concatenate([hub_src, rng.integers(0, n, 600)]).astype(np.int32)
    dst = np.concatenate([np.zeros(250, np.int32),
                          rng.integers(0, n, 600).astype(np.int32)])
    mask = rng.random(src.size) < 0.9
    feats = rng.normal(size=(n, F)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    gb_j = j_common.GraphBatch(
        x=jnp.asarray(feats), edge_src=jnp.asarray(src),
        edge_dst=jnp.asarray(dst), edge_mask=jnp.asarray(mask),
        node_mask=jnp.ones(n, bool), graph_ids=jnp.zeros(n, jnp.int32),
        n_graphs=1, targets=jnp.asarray(labels))
    gb_t = interop.graph_batch_from_numpy(gb_j)
    jcfg = j_sage.SAGEConfig(d_in=F, d_hidden=16, n_classes=5)
    params = j_sage.sage_init(jax.random.key(4), jcfg)
    model = interop.sage_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        SAGEConfig(d_in=F, d_hidden=16, n_classes=5), train=True)
    with torch.no_grad():
        _assert_logits_close(sage_apply(model, gb_t),
                             j_sage.sage_apply(params, jcfg, gb_j))
    t_params = trainable_params(model)
    t_loss = sage_loss(model, gb_t)
    assert float(t_loss) == pytest.approx(
        float(j_sage.sage_loss(params, jcfg, gb_j)), rel=1e-3)
    with mock.patch.object(j_sage, "scatter_mean", _ref_scatter_mean_once):
        loss, grads = jax.jit(jax.value_and_grad(j_sage.sage_loss),
                              static_argnums=1)(params, jcfg, gb_j)
    assert float(t_loss) == pytest.approx(float(loss), rel=1e-3)
    t_grads = dict(zip(t_params, torch.autograd.grad(
        t_loss, list(t_params.values()))))
    want_tree = jax.tree_util.tree_map(np.asarray, grads)
    for entry in interop.param_entries(model):
        want = interop._read(want_tree, entry)
        got = t_grads[entry[0]].numpy()
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max(), entry[0]


# ---------------------------------------------------------------------------
# ogb_products: GraphSAGE's full batch; the other archs refuse it
# ---------------------------------------------------------------------------

def test_ogb_products_batch_at_a_small_size():
    arch = get_arch("graphsage-reddit")
    meta = t_gnn_arch.GNN_SHAPES["ogb_products"].meta
    small = {"n_nodes": 3000, "n_edges": 40_000}
    with mock.patch.dict(meta, small):
        gb = arch.inputs("ogb_products", seed=2, device="cpu")
        specs = arch.input_specs("ogb_products")
    for k, spec in specs.items():
        t = getattr(gb, k)
        assert (tuple(t.shape), t.dtype) == (spec.shape, spec.dtype), k
    N, E = small["n_nodes"], small["n_edges"]
    assert gb.x.shape == (3072, 100) and gb.edge_src.shape == (40_448,)
    assert int(gb.node_mask.sum()) == N and bool(gb.node_mask[:N].all())
    assert int(gb.edge_mask.sum()) == E and bool(gb.edge_mask[:E].all())
    src, dst = gb.edge_src[:E].long(), gb.edge_dst[:E].long()
    assert bool((src != dst).all()) and int(max(src.max(), dst.max())) < N
    keys = src * N + dst
    assert torch.equal(torch.sort(keys).values,
                       torch.sort(dst * N + src).values)    # symmetric
    assert torch.unique(keys).numel() == E
    assert float(gb.x[N:].abs().sum()) == 0.0
    assert gb.targets.dtype == torch.int32
    assert 0 <= int(gb.targets.min()) and int(gb.targets.max()) < 47
    # the full size: the padded sizes of the reference's specs
    assert arch.input_specs("ogb_products")["x"].shape == (2_449_408, 100)
    assert arch.input_specs("ogb_products")["edge_src"].shape == (61_859_328,)


@pytest.mark.parametrize("name,what,width,size", [
    ("graphcast", "edge state (E, 512) bf16", 512, 2),
    ("schnet", "RBF expansion (E, 300) bf16", 300, 2),
    ("nequip", "rank-2 messages (E, 32·9) f32", 32 * 9, 4)])
def test_ogb_products_refusal_names_the_bytes(name, what, width, size):
    E = 61_859_140
    for call in ("input_specs", "inputs", "step_fn", "config"):
        with pytest.raises(NotImplementedError) as err:
            getattr(get_arch(name), call)("ogb_products")
        msg = str(err.value)
        assert what in msg and f"{E * width * size / 1e9:.1f} GB" in msg
        assert "Queue 1 item 7" in msg
