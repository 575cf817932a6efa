"""The port's recomputation (``models.common.remat``, the reference's
per-layer ``jax.checkpoint``) on the CPU.

  * LM archs — the reduced qwen3-1.7b, qwen3-moe-30b-a3b (MoE: the aux
    loss summed once, outside the recomputed units) and gemma2-27b (a
    (local, global) pair a unit), seeded port weights: with ``remat=True``
    under each ``REPRO_REMAT_POLICY`` (full, dots, none) the loss and every
    gradient equal those of ``remat=False`` bit for bit (the backward
    recomputes the same ops on the same inputs); the bytes the forward
    keeps for the backward — packed through
    ``torch.autograd.graph.saved_tensors_hooks`` outside the units, plus
    the products' outputs the ``dots`` policy keeps inside them (which
    the checkpoint holds itself, past those hooks) — fall in the order
    none > dots > full; no-grad forwards run as they are;
  * against the reference: qwen3 reduced with ``remat=True`` on both sides,
    the reference's ``jax.checkpoint``-ed loss and gradients (compiled once
    a session, `test_torch_train.lm_ref`), within test_torch_train's
    bounds (loss 1e-3 relative, gradients 0.05·max|g| leaf by leaf);
  * GraphCast reduced, its processor blocks recomputed: bit-equal to no
    recomputation (full_graph_sm and molecule), and against the reference
    (whose processor is always under ``jax.checkpoint``) within
    test_torch_gnn_archs.py's bounds.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import test_torch_gnn_archs as gnn_archs
from repro_torch import interop
from repro_torch.configs import qwen3_1_7b as t_qwen3
from repro_torch.configs.registry import get_arch
from repro_torch.models import common
from repro_torch.models.transformer import lm_loss, transformer_init
from repro_torch.train.step import trainable_params
from test_torch_train import _grads_close, lm_ref  # noqa: F401  (fixture)

LM_ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b", "gemma2-27b")
POLICIES = ("full", "dots", "none")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _lm(name, remat):
    cfg = dataclasses.replace(get_arch(name).config(True), remat=remat)
    model = transformer_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu", train=True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 17)))
    return model, toks[:, :-1], toks[:, 1:]


def _loss_and_grads(model, tokens, targets):
    params = trainable_params(model)
    loss = lm_loss(model, tokens, targets)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_remat_is_bit_equal(name, policy, monkeypatch):
    want = _loss_and_grads(*_lm(name, remat=False))
    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    got = _loss_and_grads(*_lm(name, remat=True))
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def _kept_bytes(model, tokens, targets, monkeypatch):
    """Bytes of the distinct storages the forward keeps for the backward
    (module docstring), the parameters' own left out."""
    kept = {}

    def keep(t):
        kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()

    def pack(t):
        keep(t)
        return t

    save = common._save_dots

    def counted(ctx, op, *args, **kwargs):
        policy = save(ctx, op, *args, **kwargs)
        if policy == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            keep(ctx.op_output)
        return policy

    monkeypatch.setattr(common, "_save_dots", counted)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lm_loss(model, tokens, targets)
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    return sum(n for ptr, n in kept.items() if ptr not in params)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_remat_keeps_fewer_bytes(name, monkeypatch):
    model, tokens, targets = _lm(name, remat=True)
    kept = {}
    for policy in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        kept[policy] = _kept_bytes(model, tokens, targets, monkeypatch)
    assert kept["none"] > kept["dots"] > kept["full"] > 0, kept
    # no grad (serving, evaluation): nothing is checkpointed
    monkeypatch.setenv("REPRO_REMAT_POLICY", "full")
    with torch.no_grad():
        assert _kept_bytes(model, tokens, targets, monkeypatch) == 0


def test_remat_policy_names_follow_reference(monkeypatch):
    monkeypatch.delenv("REPRO_REMAT_POLICY", raising=False)
    assert common.remat_policy() == "full"
    for name, want in (("none", "none"), ("dots", "dots"), ("full", "full"),
                       ("other", "full")):
        monkeypatch.setenv("REPRO_REMAT_POLICY", name)
        assert common.remat_policy() == want


def test_lm_remat_matches_reference(lm_ref):
    cfg = dataclasses.replace(t_qwen3.REDUCED, remat=True)
    model = interop.transformer_params_from_numpy(lm_ref["tree"], cfg,
                                                  train=True)
    loss = lm_loss(model, torch.as_tensor(lm_ref["tokens"]),
                   torch.as_tensor(lm_ref["targets"]))
    assert float(loss) == pytest.approx(lm_ref["remat_loss"], rel=1e-3)
    params = trainable_params(model)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    _grads_close(model, lm_ref["remat_grads"], grads, 0.05)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_graphcast_remat_is_bit_equal(shape, monkeypatch):
    arch = get_arch("graphcast")
    gb = arch.reduced_inputs(shape, device="cpu")
    model = arch.init(shape, torch.Generator().manual_seed(0), reduced=True,
                      device="cpu", train=True)
    params = trainable_params(model)
    runs = {}
    for policy in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        loss = arch.loss_fn(shape, reduced=True)(model, gb)
        runs[policy] = (loss.detach(), torch.autograd.grad(
            loss, list(params.values())))
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["none"][0])
        for a, b in zip(runs[policy][1], runs["none"][1]):
            assert torch.equal(a, b)


def test_graphcast_remat_matches_reference(monkeypatch):
    monkeypatch.setenv("REPRO_REMAT_POLICY", "full")
    case = "graphcast.full_graph_sm"
    r = gnn_archs._reference(case)
    arch, shape, t_arch, model, gb = gnn_archs._port(case, r["tree"])
    params = trainable_params(model)
    loss = t_arch.loss_fn(shape, reduced=True)(model, gb)
    assert float(loss) == pytest.approx(r["loss"], rel=1e-3)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    for entry in interop.param_entries(model):
        want = interop._read(r["grads"], entry)
        got = grads[entry[0]].numpy()
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max(), entry[0]
