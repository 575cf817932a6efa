"""The port's training slice against the JAX reference, on the CPU.

Weights are the reference's own (its ``*_init`` with a JAX key), carried
into the port as f32 masters by ``repro_torch.interop``
(``train=True``); inputs come from numpy seeds.  The reference runs once a
session (`shared_result` fixtures); its losses and gradients are compiled
by `_exact`.  Tolerances:

  * the kernels' plain versions under autograd (flash attention, the
    embedding bag, the gather-aggregate) against ``jax.grad`` of the
    reference's oracles on the same f32 inputs: rtol 1e-5, atol 1e-5 (f32
    summation order); the backward kernels' own plans (the bag's sorted
    segments, the aggregate's out-neighbour CSR) replayed in plain torch
    against autograd: the same bound in f32;
  * qwen3 reduced (the reference's ``dense`` attention): the loss within
    1e-3 relative; every gradient within 0.05·max|g| of the reference's,
    leaf by leaf (both run the forward in bf16, which rounds in other
    places in the two frameworks: the repo's logit-scale bound, here on
    the gradients).  The reference's loss and gradients are compiled with
    XLA's ``xla_allow_excess_precision`` off, so that every bf16 op
    rounds as written: its loss then equals the port's, and the largest
    gradient gap is 0.011·max|g| (0.031, a qk-norm scale, against the
    reference run op by op, whose scanned stack still fuses);
  * DLRM reduced (1 000-row tables, batch 32 × 26 tables, so ids repeat):
    the loss within 1e-6 relative (the forward is bit-exact); every
    gradient within 0.02·max|g| + 1e-6 (bf16 products; the reference's
    table gradient is a bf16 scatter that rounds after every add, the
    port's rounds once);
  * GraphSAGE reduced minibatch_lg: the loss within 1e-3 relative; every
    gradient within 0.05·max|g| (the reference's bf16 ``scatter_mean``
    rounds after every add, ROADMAP Queue 3);
  * one train step from one state (model and AdamW; the reference's step
    is its ``adamw_update`` on the loss and gradients above, as its arch
    step fns compose them, bit for bit on GraphSAGE's case, a test of its
    own): the loss as above,
    the step counter equal; parameters are not compared tightly after a
    step (step 1 of Adam is lr·sign(g), so a bf16-sized grad difference
    near 0 flips a weight by 2·lr);
  * the CLI: each logged loss within 0.01 relative of the reference CLI's
    (the same weights, the same stream; later steps add the parameter
    drift above), the reference CLI run once a session
    (`ref_cli_losses`, which the sharded CLI's test shares);
  * resume: a run cut by ``--step-budget-s`` (exit 75) and resumed ends
    on the parameters and moments of an uninterrupted run, bit for bit.
"""
import dataclasses
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn_arch as j_gnn_arch
from repro.configs import graphsage_reddit as j_sage_cfg
from repro.configs import qwen3_1_7b as j_qwen3
from repro.configs import recsys as j_recsys
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag_ref
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.kernels.gather_aggregate.ref import gather_aggregate_ref as j_agg_ref
from repro.launch import train as j_train_cli
from repro.models import dlrm as j_dlrm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.models.transformer import transformer_init as j_transformer_init
from repro.train import optimizer as j_opt

from repro_torch import interop
from repro_torch.configs import qwen3_1_7b as t_qwen3
from repro_torch.configs import recsys as t_recsys
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.embedding_bag.ops import bag_grad_plan, embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_grad_from_plan
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.gather_aggregate.ops import (
    gather_aggregate, out_neighbor_csr,
)
from repro_torch.kernels.gather_aggregate.ref import gather_aggregate_t_ref
from repro_torch.launch import train as t_train_cli
from repro_torch.models.dlrm import dlrm_loss
from repro_torch.models.transformer import lm_loss
from repro_torch.runtime import faults
from repro_torch.testing.parity import agg_inputs, bag_inputs
from repro_torch.testing.shared import SharedParts, shared_result
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import trainable_params


def _grads_close(model, want_tree, grads, scaled, atol=0.0):
    """Each port gradient against the reference's (read in the port's
    layout), within atol + scaled·max|g_ref| leaf by leaf."""
    worst = 0.0
    for entry in interop.param_entries(model):
        want = interop._read(want_tree, entry)
        got = grads[entry[0]].detach().numpy()
        assert got.shape == want.shape, entry[0]
        bound = atol + scaled * float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= bound, (entry[0], err, bound)
        worst = max(worst, err / max(float(np.abs(want).max()), 1e-30))
    return worst


def _port_grads(model, loss):
    params = trainable_params(model)
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _j(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _exact(fn, *args, static_argnums=()):
    """``fn(*args)`` compiled once with XLA's ``xla_allow_excess_precision``
    off (an option of this compile only): every bf16 op rounds as the
    source writes it, as when the reference runs op by op."""
    compiled = jax.jit(fn, static_argnums=static_argnums).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*[a for i, a in enumerate(args) if i not in static_argnums])


# ---------------------------------------------------------------------------
# the kernels' plain versions under autograd, and the backward kernels' plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 3, 30.0), (False, None, None)])
def test_flash_attention_grads_match_reference(causal, window, softcap):
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in
                   ((2, 9, 4, 8), (2, 9, 2, 8), (2, 9, 2, 8), (2, 9, 4, 8)))

    def jf(q, k, v):
        return jnp.sum(j_flash_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap) * do)

    want = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window,
                          softcap=softcap)
    out.backward(torch.as_tensor(do))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mean", [False, True])
def test_embedding_bag_grad_matches_reference(mean):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(20, 6)).astype(np.float32)
    idx = rng.integers(-1, 20, (16, 3)).astype(np.int32)   # pads, repeats
    d_out = rng.normal(size=(16, 6)).astype(np.float32)
    combiner = "mean" if mean else "sum"
    want = jax.grad(lambda t: jnp.sum(
        j_bag_ref(t, jnp.asarray(idx), combiner=combiner) * d_out))(table)
    t = torch.tensor(table, requires_grad=True)
    embedding_bag(t, torch.as_tensor(idx), combiner=combiner).backward(
        torch.as_tensor(d_out))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mean", [False, True])
def test_gather_aggregate_grad_matches_reference(mean):
    feats, nbrs = agg_inputs(40, 5, 7, torch.float32, "cpu", seed=2)
    d_out = np.random.default_rng(3).normal(size=(40, 5)).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(
        j_agg_ref(f, jnp.asarray(nbrs.numpy()), mean=mean) * d_out))(
        feats.numpy())
    f = feats.clone().requires_grad_()
    gather_aggregate(f, nbrs, mean=mean).backward(torch.as_tensor(d_out))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("T,R,D,H,mean,weighted,over", [
    (26, 50, 8, 1, False, False, False), (3, 20, 5, 4, True, True, True),
    (2, 10, 3, 3, False, True, True)])
def test_bag_grad_plan_replays_autograd(T, R, D, H, mean, weighted, over):
    # the backward kernel's input: valid ids sorted by (table, row), one
    # segment a row, each in ascending (bag, slot); replayed in plain torch
    tables, ids, w = bag_inputs(T, R, D, 64, H, torch.float32, weighted,
                                "cpu", seed=4, over=over)
    d_out = torch.as_tensor(np.random.default_rng(5).normal(size=(64, T, D)),
                            dtype=torch.float32)
    plan = bag_grad_plan(ids, w, R, mean)
    keys = plan.seg_row.numpy()
    assert (np.diff(keys) > 0).all()                 # one segment a row
    starts = plan.seg_start.numpy()
    for s in range(len(keys)):                       # entries in (b, h) order
        seg = plan.entry.numpy()[starts[s]:starts[s + 1]]
        assert (np.diff(seg) > 0).all()
    got = embedding_bag_grad_from_plan(d_out, plan, T, R)
    t = tables.detach().clone().requires_grad_()
    embedding_bag(t, ids, w, combiner="mean" if mean else "sum").backward(
        d_out)
    np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("N,F,Dmax,mean", [(60, 4, 9, True),
                                           (31, 3, 1, False),
                                           (12, 2, 30, True)])
def test_out_neighbor_csr_replays_autograd(N, F, Dmax, mean):
    feats, nbrs = agg_inputs(N, F, Dmax, torch.float32, "cpu", seed=6)
    bad = nbrs.clone()
    bad[0, 0] = N + 3                                 # outside [0, N): skipped
    assert out_neighbor_csr(bad)[0][-1] == int(((bad >= 0) & (bad < N)).sum())
    indptr, dst, deg = out_neighbor_csr(nbrs)
    assert indptr[-1] == int((nbrs >= 0).sum())
    for u in range(N):                                # destinations ascending
        rows = dst[indptr[u]:indptr[u + 1]].numpy()
        assert (np.diff(rows) >= 0).all()
        assert all((nbrs[i] == u).any() for i in rows)
    d_out = torch.as_tensor(np.random.default_rng(7).normal(size=(N, F)),
                            dtype=torch.float32)
    got = gather_aggregate_t_ref(d_out, indptr, dst, deg if mean else None)
    f = feats.clone().requires_grad_()
    gather_aggregate(f, nbrs, mean=mean).backward(d_out)
    np.testing.assert_allclose(got.numpy(), f.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bag_weights_take_no_grad():
    t = torch.zeros(5, 2, requires_grad=True)
    w = torch.ones(3, 1, requires_grad=True)
    with pytest.raises(ValueError, match="weights take no gradient"):
        embedding_bag(t, torch.zeros(3, 1, dtype=torch.int32), w)


# ---------------------------------------------------------------------------
# qwen3 reduced
# ---------------------------------------------------------------------------

LM_B, LM_S = 2, 16


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def lm_ref(tmp_path_factory):
    """Each part once for the test session (`SharedParts`)."""
    return SharedParts(tmp_path_factory, "torch-train-lm_ref", {
        "base": (("tree", "tokens", "targets", "opt"), _lm_base),
        "grads": (("loss", "grads"), _lm_grads),
        "step": (("step_loss", "step_state"), _lm_step),
        "remat": (("remat_loss", "remat_grads"), _lm_remat_grads)})


def _lm_base(_):
    params = jax.jit(j_transformer_init, static_argnums=1)(
        jax.random.key(0), j_qwen3.REDUCED)
    toks = np.random.default_rng(0).integers(
        0, j_qwen3.REDUCED.vocab, (LM_B, LM_S + 1)).astype(np.int32)
    return dict(tree=_j(params), tokens=toks[:, :-1], targets=toks[:, 1:],
                opt=j_opt.AdamWConfig(warmup_steps=1, total_steps=10))


def _lm_grads(ref):
    loss, grads = _exact(jax.value_and_grad(j_lm_loss), _jnp(ref["tree"]),
                         j_qwen3.REDUCED, jnp.asarray(ref["tokens"]),
                         jnp.asarray(ref["targets"]), static_argnums=(1,))
    return dict(loss=float(loss), grads=_j(grads))


def _lm_remat_grads(ref):
    """`_lm_grads` with ``remat=True``: each layer under ``jax.checkpoint``
    (the reference's default policy, ``full``; test_torch_remat.py)."""
    cfg = dataclasses.replace(j_qwen3.REDUCED, remat=True)
    with mock.patch.dict(os.environ, {"REPRO_REMAT_POLICY": "full"}):
        loss, grads = _exact(jax.value_and_grad(j_lm_loss),
                             _jnp(ref["tree"]), cfg,
                             jnp.asarray(ref["tokens"]),
                             jnp.asarray(ref["targets"]), static_argnums=(1,))
    return dict(remat_loss=float(loss), remat_grads=_j(grads))


def _ref_step(ref, opt):
    """One reference train step from a fresh state: its arch step fns are
    ``value_and_grad`` then ``adamw_update``, so the step is the update
    applied to the ``grads`` part's (`_exact`) loss and gradients, the
    update jitted alone (the step fns run eagerly took 9–17 s a model
    here)."""
    params = _jnp(ref["tree"])
    _, state = jax.jit(lambda g, p: j_opt.adamw_update(
        opt, g, j_opt.adamw_init(p), p))(_jnp(ref["grads"]), params)
    return dict(step_loss=ref["loss"], step_state=state)


def _lm_step(ref):
    # one train step from the same state (the reference's _train_step)
    return _ref_step(ref, ref["opt"])


def _lm_model(ref):
    return interop.transformer_params_from_numpy(ref["tree"], t_qwen3.REDUCED,
                                                 train=True)


def test_lm_masters_are_f32_and_trainable(lm_ref):
    model = _lm_model(lm_ref)
    params = trainable_params(model)
    assert len(params) == len(interop.param_entries(model))
    for name, p in params.items():
        assert p.dtype == torch.float32, name
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  lm_ref["tree"]["embed"]["table"])


def test_lm_loss_and_grads_match_reference(lm_ref):
    model = _lm_model(lm_ref)
    loss = lm_loss(model, torch.as_tensor(lm_ref["tokens"]),
                   torch.as_tensor(lm_ref["targets"]))
    assert float(loss) == pytest.approx(lm_ref["loss"], rel=1e-3)
    _grads_close(model, lm_ref["grads"], _port_grads(model, loss), 0.05)


def test_lm_train_step_matches_reference(lm_ref):
    model = _lm_model(lm_ref)
    state = interop.adamw_state_from_numpy(
        _j(j_opt.adamw_init(lm_ref["tree"])), model)
    step = get_arch("qwen3-1.7b").step_fn("train_4k",
                                          opt=_port_opt(lm_ref["opt"]))
    loss, model, state = step(model, state,
                              torch.as_tensor(lm_ref["tokens"]),
                              torch.as_tensor(lm_ref["targets"]))
    assert float(loss) == pytest.approx(lm_ref["step_loss"], rel=1e-3)
    assert int(state.step) == int(lm_ref["step_state"].step) == 1
    # the moments carry back to the reference's layout: m = (1 − b1)·g
    # after one step, so m holds the clipped gradient to the same bound
    _, mu, _ = interop.adamw_state_to_numpy(state, model, lm_ref["tree"])
    want_mu = _j(lm_ref["step_state"].mu)
    for entry in interop.param_entries(model):
        got, want = interop._read(mu, entry), interop._read(want_mu, entry)
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max(), entry


def _port_opt(jopt):
    """The port's `AdamWConfig` with the fields of the reference's."""
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(**dataclasses.asdict(jopt))


def test_adamw_state_round_trips_through_interop(lm_ref):
    model = _lm_model(lm_ref)
    rng = np.random.default_rng(9)
    noisy = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), lm_ref["tree"])
    jstate = (np.int32(4), noisy, lm_ref["tree"])
    state = interop.adamw_state_from_numpy(jstate, model)
    assert int(state.step) == 4 and state.step.dtype == torch.int32
    back = interop.adamw_state_to_numpy(state, model, lm_ref["tree"])
    assert int(back[0]) == 4
    for got, want in zip(jax.tree_util.tree_leaves(back[1:]),
                         jax.tree_util.tree_leaves(jstate[1:])):
        np.testing.assert_array_equal(got, want)
    params = interop.params_to_numpy(model, lm_ref["tree"])
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(lm_ref["tree"])):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# DLRM reduced: 1 000-row tables, batch 32 × 26 (repeated ids are certain)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dlrm_ref(tmp_path_factory):
    """Each part once for the test session (`SharedParts`)."""
    return SharedParts(tmp_path_factory, "torch-train-dlrm_ref", {
        "base": (("tree", "x"), _dlrm_base),
        "grads": (("loss", "grads"), _dlrm_grads),
        "step": (("step_loss", "step_state"), _dlrm_step)})


_J_DLRM_ARCH = j_recsys.RecsysArch("dlrm-rm2", j_recsys.CONFIG,
                                   j_recsys.REDUCED)


def _dlrm_base(_):
    params = jax.jit(j_dlrm.dlrm_init, static_argnums=1)(
        jax.random.key(3), j_recsys.REDUCED)
    x = {k: np.asarray(v) for k, v in
         _J_DLRM_ARCH.reduced_inputs("train_batch", None).items()}
    return dict(tree=_j(params), x=x)


def _dlrm_args(ref):
    return [jnp.asarray(ref["x"][k]) for k in ("dense", "sparse_idx",
                                              "labels")]


def _dlrm_grads(ref):
    loss, grads = _exact(jax.value_and_grad(j_dlrm.dlrm_loss),
                         _jnp(ref["tree"]), j_recsys.REDUCED,
                         *_dlrm_args(ref), static_argnums=(1,))
    return dict(loss=float(loss), grads=_j(grads))


def _dlrm_step(ref):
    return _ref_step(ref, _J_DLRM_ARCH.opt)


def test_dlrm_batch_has_repeated_ids(dlrm_ref):
    idx = dlrm_ref["x"]["sparse_idx"]
    assert idx.shape == (32, 26, 1)
    assert any(len(np.unique(idx[:, t])) < 32 for t in range(26))


def test_dlrm_loss_and_grads_match_reference(dlrm_ref):
    model = interop.dlrm_params_from_numpy(dlrm_ref["tree"],
                                           t_recsys.REDUCED, train=True)
    assert model.tables.dtype == torch.float32
    x = {k: torch.as_tensor(v) for k, v in dlrm_ref["x"].items()}
    loss = dlrm_loss(model, x["dense"], x["sparse_idx"], x["labels"])
    assert float(loss) == pytest.approx(dlrm_ref["loss"], rel=1e-6)
    _grads_close(model, dlrm_ref["grads"], _port_grads(model, loss), 0.02,
                 atol=1e-6)


def test_dlrm_train_step_matches_reference(dlrm_ref):
    arch = get_arch("dlrm-rm2")
    model = interop.dlrm_params_from_numpy(dlrm_ref["tree"],
                                           t_recsys.REDUCED, train=True)
    state = interop.adamw_state_from_numpy(
        _j(j_opt.adamw_init(dlrm_ref["tree"])), model)
    x = {k: torch.as_tensor(v) for k, v in dlrm_ref["x"].items()}
    loss, model, state = arch.step_fn("train_batch")(
        model, state, x["dense"], x["sparse_idx"], x["labels"])
    assert float(loss) == pytest.approx(dlrm_ref["step_loss"], rel=1e-6)
    assert int(state.step) == 1
    # the tables' moments are dense: rows no bag named only decay
    untouched = np.ones(t_recsys.REDUCED.table_rows, bool)
    untouched[dlrm_ref["x"]["sparse_idx"][:, 0, 0]] = False
    assert float(state.mu["tables"][0][untouched].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# GraphSAGE reduced minibatch_lg
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sage_ref(tmp_path_factory):
    """Each part once for the test session (`SharedParts`)."""
    return SharedParts(tmp_path_factory, "torch-train-sage_ref", {
        "base": (("tree",), _sage_base),
        "grads": (("loss", "grads"), _sage_grads),
        "step": (("step_loss", "step_state"), _sage_step)})


def _sage_base(_):
    init = j_sage_cfg.ARCH._build("minibatch_lg", True)[1]
    return dict(tree=_j(jax.jit(init)(jax.random.key(1))))


def _sage_batch():
    return j_sage_cfg.ARCH.reduced_inputs("minibatch_lg", None)["batch"]


def _sage_grads(ref):
    jloss = j_sage_cfg.ARCH._build("minibatch_lg", True)[2]
    loss, grads = _exact(jax.value_and_grad(jloss), _jnp(ref["tree"]),
                         _sage_batch())
    return dict(loss=float(loss), grads=_j(grads))


def _sage_step(ref):
    return _ref_step(ref, j_sage_cfg.ARCH.opt)


def _sage_model(ref):
    arch = get_arch("graphsage-reddit")
    return arch, interop.sage_params_from_numpy(
        ref["tree"], arch.config("minibatch_lg", True), train=True)


def test_sage_loss_and_grads_match_reference(sage_ref):
    arch, model = _sage_model(sage_ref)
    gb = arch.reduced_inputs("minibatch_lg", device="cpu")
    loss = arch.loss_fn("minibatch_lg", reduced=True)(model, gb)
    assert float(loss) == pytest.approx(sage_ref["loss"], rel=1e-3)
    _grads_close(model, sage_ref["grads"], _port_grads(model, loss), 0.05)


def test_sage_train_step_matches_reference(sage_ref):
    arch, model = _sage_model(sage_ref)
    state = interop.adamw_state_from_numpy(
        _j(j_opt.adamw_init(sage_ref["tree"])), model)
    gb = arch.reduced_inputs("minibatch_lg", device="cpu")
    loss, model, state = arch.step_fn("minibatch_lg", reduced=True)(
        model, state, gb)
    assert float(loss) == pytest.approx(sage_ref["step_loss"], rel=1e-3)
    assert int(state.step) == 1
    assert not gb.x.requires_grad


def test_reference_step_fn_is_update_on_grads(sage_ref):
    """The reference's own step fn (compiled as `_exact`) against the step
    `_ref_step` rebuilds from its ``adamw_update``, on GraphSAGE's reduced
    case: the same loss, step counter and moments."""
    params = _jnp(sage_ref["tree"])
    loss1, _, state1 = _exact(j_sage_cfg.ARCH.reduced_step_fn(
        "minibatch_lg"), params, j_opt.adamw_init(params), _sage_batch())
    want = sage_ref["step_state"]
    assert float(loss1) == sage_ref["step_loss"]
    assert int(state1.step) == int(want.step) == 1
    for tree1, tree0 in ((state1.mu, want.mu), (state1.nu, want.nu)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, _j(tree1),
                               _j(tree0))


# ---------------------------------------------------------------------------
# the trainer CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "6", "--batch", "2",
       "--seq", "16", "--log-every", "1", "--ckpt-every", "4", "--seed", "0"]
LOSS_LINE = re.compile(r"\[train\] step=(\d+) loss=([0-9.]+)")


def _losses(text):
    return {int(s): float(v) for s, v in LOSS_LINE.findall(text)}


def _seed_port_checkpoint(ckpt_dir, steps=6):
    """The reference CLI's initial state (its weights from seed 0, zero
    moments) as a port checkpoint at step −1, so that the port's CLI starts
    where the reference's does."""
    jcfg = j_qwen3.REDUCED
    tree = _j(j_transformer_init(jax.random.key(0), jcfg))
    model = interop.transformer_params_from_numpy(tree, t_qwen3.REDUCED,
                                                  train=True)
    state = interop.adamw_state_from_numpy(_j(j_opt.adamw_init(tree)), model)
    ckpt.save(ckpt_dir, -1, t_train_cli.state_tree(model, state),
              extra={"data_step": 0})


def _reference_cli_losses(work):
    """The reference CLI's loss lines on `CLI`, {step: loss}."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_train_cli.main(CLI + ["--ckpt-dir", str(work / "j")]) == 0
    return _losses(buf.getvalue())


@pytest.fixture(scope="module")
def ref_cli_losses(tmp_path_factory):
    """The reference CLI's run once for the test session (`shared_result`;
    ``tests/test_torch_sharding.py`` reads it too)."""
    return shared_result(tmp_path_factory, "torch-train-ref-cli",
                         _reference_cli_losses)


def test_cli_losses_match_reference_cli(tmp_path, capsys, ref_cli_losses):
    want = ref_cli_losses
    _seed_port_checkpoint(tmp_path / "t")
    assert t_train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "t"),
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step -1" in out
    got = _losses(out)
    assert sorted(got) == sorted(want) == list(range(6))
    for s in want:
        assert got[s] == pytest.approx(want[s], rel=0.01), s
    assert ckpt.latest_step(tmp_path / "t") == 5
    assert (tmp_path / "t" / "heartbeat").exists()


def _final_state(ckpt_dir):
    arch = get_arch("qwen3-1.7b")
    model = arch.init(torch.Generator().manual_seed(1), reduced=True,
                      device="cpu", train=True)
    state, extra, step = t_train_cli.restore_into(model, ckpt_dir, "cpu")
    return trainable_params(model), state, extra, step


def test_straggler_exit_75_then_resume_is_bit_exact(tmp_path, capsys):
    args = CLI + ["--device", "cpu"]
    assert t_train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a")]) == 0
    faults.install(faults.FaultPlan([faults.FaultSpec(
        "train.step", "stall", at=4, stall_s=60.0)]))
    try:
        rc = t_train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                      "--step-budget-s", "3"])
    finally:
        faults.clear()
    assert rc == t_train_cli.EXIT_STRAGGLER == 75
    out = capsys.readouterr().out
    assert "[train] step 3 straggled; checkpoint-restart" in out
    assert ckpt.latest_step(tmp_path / "b") == 2      # the last finished step
    assert t_train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b")]) == 0
    assert "[train] resumed from step 2" in capsys.readouterr().out
    pa, sa, ea, _ = _final_state(tmp_path / "a")
    pb, sb, eb, _ = _final_state(tmp_path / "b")
    assert ea == eb == {"data_step": 6}
    assert int(sa.step) == int(sb.step) == 6
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(sa.mu[name], sb.mu[name]), name
        assert torch.equal(sa.nu[name], sb.nu[name]), name


def test_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(SystemExit, match="LM archs"):
        t_train_cli.main(["--arch", "dlrm-rm2", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])
    # one process, no group: a (1/2, 2) mesh fails the reference's
    # assertion, in both trainers (sharded runs: test_torch_sharding.py)
    for cli, extra in ((j_train_cli, []), (t_train_cli, ["--device", "cpu"])):
        with pytest.raises(AssertionError):
            cli.main(["--model-parallel", "2", "--reduced", "--ckpt-dir",
                      str(tmp_path / "mp2")] + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_train_cli.main(["--reduced", "--ckpt-dir", str(tmp_path)])


def test_train_steps_equal_reference_shapes():
    for shape in j_gnn_arch.GNN_SHAPES:     # ogb_products: CSR aggregate
        assert callable(get_arch("graphsage-reddit").step_fn(shape))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch("graphcast").step_fn("ogb_products")
    assert dataclasses.asdict(get_arch("dlrm-rm2").opt) == \
        dataclasses.asdict(j_recsys.RecsysArch("x", j_recsys.CONFIG,
                                               j_recsys.REDUCED).opt)
    assert dataclasses.asdict(get_arch("qwen3-1.7b").opt) == \
        dataclasses.asdict(j_qwen3.ARCH.opt)
    assert dataclasses.asdict(get_arch("graphsage-reddit").opt) == \
        dataclasses.asdict(j_sage_cfg.ARCH.opt)
