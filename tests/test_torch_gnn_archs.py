"""The port's GNN archs (schnet, nequip, graphcast, and graphsage-reddit's
graph-level head) against the JAX reference, on the CPU, at the reduced
configs of the shapes full_graph_sm and molecule.

The reference's weights (its ``init`` with a JAX key) are carried into the
port as f32 masters by ``repro_torch.interop``; both packages'
``reduced_inputs`` give the batch, which must be bit-equal.  Each case's
one test runs the reference once: its init, forward, loss, gradients and
AdamW update on those gradients in one compile with XLA's
``xla_allow_excess_precision`` off (every bf16 op rounds as written, as
``tests/test_torch_train.py`` does).  Tolerances:

  * forward: nequip (f32 throughout) within 1e-4·max|out|; schnet,
    graphcast and graphsage (bf16) within the repo's bf16 bound
    0.02·max|out| + 0.05.  The reference's bf16 scatter (``.at[].add`` on
    XLA's CPU) rounds after every add; the port's ``index_add_`` sums in f32
    on the CPU and rounds once (and on the card adds with atomics, in no
    fixed order: no card result is held bit-equal here);
  * loss: within 1e-3 relative — but for schnet's molecule loss, a mean
    over 4 graphs of squared bf16 sum-pools, whose per-add roundings move
    it ~1 %: there the port's loss is held within 1e-3 of the reference's
    run with its scatters patched (in this process only) to round once as
    ``index_add_`` does, and the unpatched outputs to the bf16 bound;
  * gradients: within 0.05·max|g| leaf by leaf (test_torch_train's bound);
  * one AdamW step from the same state: the loss as above, the step counter
    equal, the first moments within 0.05·max|m| leaf by leaf (m = (1 − b1)·
    clipped g after one step), every parameter within 2·lr₁ + 1e-6·|p| of
    the reference's (step 1 of Adam moves each weight by lr₁·g/(|g| + ε):
    a gradient that differs near 0 flips the move, test_torch_train's
    reason for not comparing parameters tightly).

Also, torch only: NequIP's E(3) invariance and SchNet's cutoff (the port's
versions of ``tests/models/test_gnn.py``); input specs equal to the
reference's for every ported (arch, shape); and the full-size batch
builders at their real sizes.  And graphcast at full width on
full_graph_sm's full-size batch, the reference and the port on the same
weights: finite at 4 layers, its loss overflowing f32 at 16.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn_arch as j_gnn_arch
from repro.configs import graphcast as j_graphcast_cfg
from repro.configs import graphsage_reddit as j_sage_cfg
from repro.configs import nequip as j_nequip_cfg
from repro.configs import schnet as j_schnet_cfg
from repro.models.gnn import common as j_common
from repro.models.gnn import graphcast as j_graphcast
from repro.models.gnn import graphsage as j_sage
from repro.models.gnn import nequip as j_nequip
from repro.models.gnn import schnet as j_schnet
from repro.train import optimizer as j_opt

from repro_torch import interop
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.models.gnn import common as t_common
from repro_torch.models.gnn.graphcast import graphcast_apply, graphcast_init
from repro_torch.models.gnn.graphsage import sage_apply
from repro_torch.models.gnn.nequip import (
    NequIPConfig, nequip_apply, nequip_init,
)
from repro_torch.models.gnn.schnet import (
    SchNetConfig, schnet_apply, schnet_init,
)
from repro_torch.train.optimizer import schedule
from repro_torch.train.step import init_opt_state, trainable_params

# arch → (reference config module, reference apply, port apply, loader)
ARCHS = {
    "schnet": (j_schnet_cfg, j_schnet.schnet_apply, schnet_apply,
               interop.schnet_params_from_numpy),
    "nequip": (j_nequip_cfg, j_nequip.nequip_apply, nequip_apply,
               interop.nequip_params_from_numpy),
    "graphcast": (j_graphcast_cfg, j_graphcast.graphcast_apply,
                  graphcast_apply, interop.graphcast_params_from_numpy),
    "graphsage-reddit": (j_sage_cfg, j_sage.sage_apply, sage_apply,
                         interop.sage_params_from_numpy),
}
SHAPES = ("full_graph_sm", "molecule")
CASES = [f"{a}.{s}" for a in ARCHS for s in SHAPES]
F32_ARCHS = ("nequip",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _exact(fn, *args):
    """``fn(*args)`` compiled with ``xla_allow_excess_precision`` off."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})(*args)


def _j(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_scatter_once(messages, dst, mask, n_nodes):
    """The reference's ``scatter_sum`` summed in f32, rounded once."""
    msg = jnp.where(mask[:, None], messages, 0).astype(jnp.float32)
    out = jnp.zeros((n_nodes, messages.shape[-1]), jnp.float32)
    return out.at[dst].add(msg).astype(messages.dtype)


def _ref_pool_once(node_feat, graph_ids, node_mask, n_graphs, *, mean=True):
    assert not mean
    return _ref_scatter_once(node_feat, graph_ids, node_mask, n_graphs)


def _reference(case):
    """The case's reference run: weights, forward, loss, gradients and one
    AdamW update from a fresh state, in one compile."""
    arch, shape = case.split(".")
    j_cfg_mod, j_apply = ARCHS[arch][:2]
    j_arch = j_cfg_mod.ARCH
    cfg, init, loss_fn = j_arch._build(shape, True)
    gb = j_arch.reduced_inputs(shape, None)["batch"]

    def run(key, g):
        p = init(key)
        loss, grads = jax.value_and_grad(loss_fn)(p, g)
        new, state = j_opt.adamw_update(j_arch.opt, grads,
                                        j_opt.adamw_init(p), p)
        return p, j_apply(p, cfg, g), loss, grads, new, state

    params, out, loss, grads, new, state = _exact(run, jax.random.key(1), gb)
    res = dict(tree=_j(params), out=np.asarray(out).astype(np.float32),
               loss=float(loss), grads=_j(grads), step_tree=_j(new),
               step_mu=_j(state.mu), step=int(state.step))
    if arch == "schnet" and shape == "molecule":
        with mock.patch.object(j_schnet, "scatter_sum", _ref_scatter_once), \
                mock.patch.object(j_schnet, "segment_pool", _ref_pool_once):
            res["loss_once"] = float(_exact(loss_fn, params, gb))
    return res


def _port(case, tree):
    """(arch, shape, port arch, model with the reference's masters, batch)
    with the batch held bit-equal to the reference's."""
    arch, shape = case.split(".")
    j_cfg_mod, _, _, load = ARCHS[arch]
    t_arch = get_arch(arch)
    jcfg = j_cfg_mod.ARCH._build(shape, True)[0]
    tcfg = t_arch.config(shape, reduced=True)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    gb_j = j_cfg_mod.ARCH.reduced_inputs(shape, None)["batch"]
    gb = t_arch.reduced_inputs(shape, device="cpu")
    for f in dataclasses.fields(gb_j):
        want, got = getattr(gb_j, f.name), getattr(gb, f.name)
        if f.name == "n_graphs" or want is None:
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return arch, shape, t_arch, load(tree, tcfg, train=True), gb


def _assert_out_close(arch, got, want):
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if arch in F32_ARCHS:
        bound = 1e-4 * scale
    else:
        bound = 0.02 * scale + 0.05
    err = float(np.abs(got - want).max())
    assert err <= bound, (arch, err, bound)


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_reference(case):
    """Forward, loss, gradients and one AdamW step of the case against the
    reference's, within the module docstring's tolerances."""
    r = _reference(case)
    arch, shape, t_arch, model, gb = _port(case, r["tree"])
    _assert_out_close(arch, ARCHS[arch][2](model, gb), r["out"])
    params = trainable_params(model)
    assert len(params) == len(interop.param_entries(model))
    loss = t_arch.loss_fn(shape, reduced=True)(model, gb)
    assert float(loss) == pytest.approx(r.get("loss_once", r["loss"]),
                                        rel=1e-3)
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), materialize_grads=True)))
    for entry in interop.param_entries(model):
        want = interop._read(r["grads"], entry)
        got = grads[entry[0]].numpy()
        assert got.shape == want.shape, entry[0]
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max(), entry[0]

    state = init_opt_state(model)
    loss1, model, state = t_arch.step_fn(shape, reduced=True)(model, state,
                                                              gb)
    assert float(loss1) == float(loss)
    assert int(state.step) == r["step"] == 1
    lr1 = float(schedule(t_arch.opt, torch.tensor(1)))
    new = interop.params_to_numpy(model, r["tree"])
    for entry in interop.param_entries(model):
        got, want = interop._read(new, entry), interop._read(r["step_tree"],
                                                             entry)
        bound = 2 * lr1 * (1 + 1e-3) + 1e-6 * np.abs(want)
        assert (np.abs(got - want) <= bound).all(), entry[0]
        m = state.mu[entry[0]].numpy()
        want_m = interop._read(r["step_mu"], entry)
        assert np.abs(m - want_m).max() <= 0.05 * np.abs(want_m).max(), \
            entry[0]


@pytest.mark.parametrize("arch", ["schnet", "nequip", "graphcast"])
def test_interop_round_trips(arch):
    """The port's weights and moments into the reference's pytree (shaped
    by ``jax.eval_shape`` of its init) and back, bit for bit."""
    j_arch, t_arch = ARCHS[arch][0].ARCH, get_arch(arch)
    _, init, _ = j_arch._build("molecule", True)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(init, jax.random.key(0)))
    model = t_arch.init("molecule", torch.Generator().manual_seed(3),
                        reduced=True, device="cpu", train=True)
    tree = interop.params_to_numpy(model, template)
    back = ARCHS[arch][3](tree, model.cfg, train=True)
    for (name, p), q in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(p, q), name
    state = init_opt_state(model)
    for i, m in enumerate(state.mu.values()):
        m.normal_(generator=torch.Generator().manual_seed(i))
    step, mu, nu = interop.adamw_state_to_numpy(state, model, template)
    again = interop.adamw_state_from_numpy((step, mu, nu), back)
    assert int(again.step) == 0
    for name in state.mu:
        assert torch.equal(again.mu[name], state.mu[name]), name
        assert torch.equal(again.nu[name], state.nu[name]), name


def test_nequip_serving_weights_stay_f32():
    arch = get_arch("nequip")
    model = arch.init("molecule", torch.Generator().manual_seed(0),
                      reduced=True, device="cpu")
    dtypes = {p.dtype for p in model.parameters()}
    assert dtypes == {torch.float32}
    assert not any(p.requires_grad for p in model.parameters())
    served = get_arch("schnet").init("molecule",
                                     torch.Generator().manual_seed(0),
                                     reduced=True, device="cpu")
    assert {p.dtype for p in served.parameters()} == {torch.bfloat16}


# ---------------------------------------------------------------------------
# properties (torch only)
# ---------------------------------------------------------------------------

def _batch(rng, N=12, E=30, F=6):
    return t_common.GraphBatch(
        x=torch.as_tensor(rng.normal(size=(N, F)), dtype=torch.float32),
        edge_src=torch.as_tensor(rng.integers(0, N, E), dtype=torch.int32),
        edge_dst=torch.as_tensor(rng.integers(0, N, E), dtype=torch.int32),
        edge_mask=torch.ones(E, dtype=torch.bool),
        node_mask=torch.ones(N, dtype=torch.bool),
        graph_ids=torch.zeros(N, dtype=torch.int32), n_graphs=1,
        targets=torch.zeros(1),
        pos=torch.as_tensor(rng.normal(size=(N, 3)), dtype=torch.float32))


def _rotation(rng):
    Q, R = np.linalg.qr(rng.normal(size=(3, 3)))
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return torch.as_tensor(Q, dtype=torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nequip_e3_invariance(seed):
    """The energy is invariant under a global rotation and translation, and
    not under a non-rigid distortion."""
    rng = np.random.default_rng(seed)
    gb = _batch(rng)
    model = nequip_init(NequIPConfig(d_in=6, d_hidden=8, n_layers=3),
                        torch.Generator().manual_seed(seed))
    e1 = nequip_apply(model, gb)
    Q = _rotation(rng)
    t = torch.as_tensor(rng.normal(size=(1, 3)), dtype=torch.float32)
    e2 = nequip_apply(model, dataclasses.replace(gb, pos=gb.pos @ Q.T + t))
    torch.testing.assert_close(e1, e2, atol=2e-4, rtol=2e-4)
    e3 = nequip_apply(model, dataclasses.replace(
        gb, pos=gb.pos * torch.tensor([2.0, 1.0, 0.5])))
    assert float((e1 - e3).abs().max()) > 1e-4


def test_schnet_cutoff_kills_long_edges():
    rng = np.random.default_rng(5)
    N = 6
    pos = np.zeros((N, 3), np.float32)
    pos[3:] += 100.0                                      # far cluster
    gb = t_common.GraphBatch(
        x=torch.as_tensor(rng.normal(size=(N, 4)), dtype=torch.float32),
        edge_src=torch.tensor([0, 1, 3, 0], dtype=torch.int32),
        edge_dst=torch.tensor([1, 2, 4, 3], dtype=torch.int32),  # 0→3 spans
        edge_mask=torch.ones(4, dtype=torch.bool),
        node_mask=torch.ones(N, dtype=torch.bool),
        graph_ids=torch.zeros(N, dtype=torch.int32), n_graphs=1,
        targets=torch.zeros(1), pos=torch.as_tensor(pos))
    model = schnet_init(SchNetConfig(d_in=4, d_hidden=8, n_rbf=16,
                                     cutoff=5.0, graph_level=False, n_out=2),
                        torch.Generator().manual_seed(0))
    out1 = schnet_apply(model, gb)
    out2 = schnet_apply(model, dataclasses.replace(
        gb, edge_mask=torch.tensor([True, True, True, False])))
    assert torch.equal(out1, out2)        # the envelope is exactly 0 there


def test_scatter_max_and_node_regression_loss_match_reference():
    from repro.models.gnn import common as j_common
    rng = np.random.default_rng(7)
    E, N, F = 40, 9, 3
    msg = rng.normal(size=(E, F)).astype(np.float32)
    dst = rng.integers(0, N - 1, E).astype(np.int32)  # node N-1 gets nothing
    mask = rng.random(E) < 0.7
    want = j_common.scatter_max(jnp.asarray(msg), jnp.asarray(dst),
                                jnp.asarray(mask), N)
    got = t_common.scatter_max(torch.as_tensor(msg), torch.as_tensor(dst),
                               torch.as_tensor(mask), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pred = rng.normal(size=(N, F)).astype(np.float32)
    nmask = rng.random(N) < 0.8
    for tgt in (rng.normal(size=(N,)), rng.normal(size=(N, F))):
        tgt = tgt.astype(np.float32)
        want = float(j_common.node_regression_loss(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(nmask)))
        got = float(t_common.node_regression_loss(
            torch.as_tensor(pred), torch.as_tensor(tgt),
            torch.as_tensor(nmask)))
        assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# specs and the full-size builders
# ---------------------------------------------------------------------------

J_ARCHS = {"schnet": j_schnet_cfg, "nequip": j_nequip_cfg,
           "graphcast": j_graphcast_cfg, "graphsage-reddit": j_sage_cfg}


@pytest.mark.parametrize("arch", list(J_ARCHS))
@pytest.mark.parametrize("shape", list(j_gnn_arch.GNN_SHAPES))
def test_input_specs_equal_reference(arch, shape):
    j_arch, t_arch = J_ARCHS[arch].ARCH, get_arch(arch)
    assert t_arch.needs_positions == j_arch.needs_positions
    if shape not in t_arch.ported_shapes:
        for call in (t_arch.input_specs, t_arch.reduced_inputs,
                     t_arch.step_fn, t_arch.inputs):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                call(shape)
        return
    for reduced in (False, True):
        want = j_arch.input_specs(shape, reduced=reduced)["batch"]
        got = t_arch.input_specs(shape, reduced=reduced)
        assert set(got) == {f.name for f in dataclasses.fields(want)
                            if getattr(want, f.name) is not None
                            and f.name != "n_graphs"}
        for k, spec in got.items():
            w = getattr(want, k)
            assert (spec.shape, str(spec.dtype)[6:]) == (w.shape,
                                                         str(w.dtype)), k
        assert t_arch.meta(shape, reduced) == j_arch._meta(shape, reduced)
    assert callable(t_arch.step_fn(shape))


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_full_size_batch_builder(shape):
    arch = get_arch("schnet")
    meta = arch.meta(shape)
    gb = arch.inputs(shape, seed=3, device="cpu")
    specs = arch.input_specs(shape)
    for k, spec in specs.items():
        t = getattr(gb, k)
        assert (tuple(t.shape), t.dtype) == (spec.shape, spec.dtype), k
    N, E = meta["n_nodes"], meta["n_edges"]
    assert int(gb.node_mask.sum()) == N and bool(gb.node_mask[:N].all())
    assert int(gb.edge_mask.sum()) == E and bool(gb.edge_mask[:E].all())
    src, dst = gb.edge_src[:E].long(), gb.edge_dst[:E].long()
    assert int(src.max()) < N and int(dst.max()) < N
    assert bool((src != dst).all())
    keys = src * N + dst
    assert torch.equal(torch.sort(keys).values,
                       torch.sort(dst * N + src).values)    # both directions
    assert torch.unique(keys).numel() == E                   # no repeat
    assert float(gb.x[N:].abs().sum()) == 0.0
    assert gb.n_graphs == meta["n_graphs"]
    if shape == "molecule":
        gid = gb.graph_ids[:N].long()
        assert torch.equal(gid, torch.arange(128).repeat_interleave(30))
        assert bool((gid[src] == gid[dst]).all())            # within a graph
        assert torch.bincount(gid[src], minlength=128).tolist() == [128] * 128
        for g in (0, 77, 127):                               # connected
            seen, frontier = {30 * g}, [30 * g]
            sel = gid[src] == g
            adj = {}
            for a, b in zip(src[sel].tolist(), dst[sel].tolist()):
                adj.setdefault(a, []).append(b)
            while frontier:
                nxt = [b for a in frontier for b in adj.get(a, ())
                       if b not in seen]
                seen.update(nxt)
                frontier = nxt
            assert len(seen) == 30
        assert gb.targets.shape == (128,)
    else:
        assert not bool(gb.graph_ids.any())
        assert int(gb.targets.max()) < meta["n_out"]
    again = get_arch("graphsage-reddit").inputs(shape, seed=3, device="cpu")
    assert again.pos is None and torch.equal(again.x, gb.x)
    assert torch.equal(again.targets, gb.targets)
    with pytest.raises(ValueError, match="sampler"):
        arch.inputs("minibatch_lg", device="cpu")


# graphcast at full width on full_graph_sm's full-size batch: layers →
# (loss finite, gradient norm finite or None when not taken)
GRAPHCAST_DEPTHS = {4: (True, True), 16: (False, None)}


@pytest.mark.parametrize("layers", list(GRAPHCAST_DEPTHS))
def test_graphcast_full_graph_sm_overflows_as_reference(layers):
    """GraphCast's processor sums edge states into the nodes with no
    normalisation, so at full_graph_sm's R-MAT hub (in-degree 274) its
    states grow each layer: the reference and the port, on the same
    full-width weights and the full-size batch, both keep the loss and the
    gradient norm finite at 4 layers and overflow the loss at 16 (why
    ``chip_smoke.py`` trains 4 layers there)."""
    want_loss, want_grad = GRAPHCAST_DEPTHS[layers]
    t_arch = get_arch("graphcast")
    cfg = dataclasses.replace(t_arch.config("full_graph_sm"),
                              n_layers=layers)
    jcfg = j_graphcast.GraphCastConfig(**dataclasses.asdict(cfg))
    model = graphcast_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu", train=True)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda k: j_graphcast.graphcast_init(k, jcfg), jax.random.key(0)))
    tree = interop.params_to_numpy(model, template)
    gb = t_arch.inputs("full_graph_sm", seed=0, device="cpu")
    n_edges = int(gb.edge_mask.sum())
    assert int(torch.bincount(gb.edge_dst[:n_edges].long()).max()) == 274
    gb_j = j_common.GraphBatch(**{
        f.name: (v.numpy() if isinstance(v, torch.Tensor) else v)
        for f in dataclasses.fields(gb) for v in [getattr(gb, f.name)]})

    def j_loss(p, g):       # the reference config's loss, at this depth
        pred = j_graphcast.graphcast_apply(p, jcfg, g)
        tgt = jnp.broadcast_to(g.targets.astype(jnp.float32)[:, None],
                               pred.shape)
        return j_common.node_regression_loss(pred, tgt, g.node_mask)

    def j_loss_and_norm(p, g):
        loss, grads = jax.value_and_grad(j_loss)(p, g)
        return loss, jnp.sqrt(sum(jnp.sum(jnp.square(x)) for x in
                                  jax.tree_util.tree_leaves(grads)))

    loss = t_arch.loss_fn("full_graph_sm")(model, gb)
    if want_grad is None:
        got = [float(_exact(j_loss, tree, gb_j)), float(loss)]
    else:
        got = [float(v) for v in _exact(j_loss_and_norm, tree, gb_j)]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        got += [float(loss), float(torch.sqrt(sum(
            g.float().square().sum() for g in grads)))]
    finite = [bool(np.isfinite(v)) for v in got]
    want = [want_loss] if want_grad is None else [want_loss, want_grad]
    assert finite == want * 2, (layers, "reference, port:", got)


def test_registry_lists_every_gnn_arch():
    assert sorted(list_archs("gnn")) == sorted(J_ARCHS)
    for name in J_ARCHS:
        assert get_arch(name).family == "gnn"
        assert dataclasses.asdict(get_arch(name).opt) == \
            dataclasses.asdict(J_ARCHS[name].ARCH.opt)
