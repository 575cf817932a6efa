"""The port's Mixture-of-Experts layer and MoE archs against the JAX reference, on the CPU.

Weights are the reference's own (``moe_init`` / ``transformer_init`` with
a JAX key), carried into the port; inputs come from numpy seeds.

The reference's slot table ``tok_of_slot`` is read from its own run: the
dispatched tokens ``xe`` reach ``constrain`` (a no-op outside a mesh,
wrapped here to record them), and each slot's row is the gathered row of
x, unchanged, so its token is the x row it equals (an empty slot is a
zero row: sentinel S).  Its routing is the reference's own three ops
(router product, softmax, ``lax.top_k``), run on their own.  The
reference runs compiled by `_exact` (below).

Tolerances:
  * routing (``idx``), ``tok_of_slot``, the kept counts and the dropped
    assignments: equal.  A choice that flips on a near-tie fails with the
    router-probability gap at the flip, never with a looser comparison;
  * ``y`` in f32: rtol 1e-5 with atol 1e-6·max|y| (the expert products'
    summation order differs between XLA and torch); in bf16: within 2
    units in the last place of bf16 at |y| (2·2⁻⁸·|y|) plus 2⁻⁸·max|y|
    (a bf16 product rounded the other way moves the combine's adds by one
    unit of its operands; with torch 2.13 on x86-64 the bf16 outputs
    came out equal bit for bit);
  * ``aux``: within 2 f32 ulps;
  * whole models (the archs' ``REDUCED``): logits within the repo's
    logit-scale bound ``0.02·max|b| + 0.05``, aux within 2 f32 ulps;
    ``lm_loss`` within 1e-3 relative and every gradient within
    0.05·max|g| leaf by leaf (``test_torch_train.py``'s tolerances).

The whole-model reference is compiled with XLA's
``xla_allow_excess_precision`` off (`_exact`, an option of that one
compile), so that its scanned stack rounds every bf16 op as the source
writes it, as the port and the reference's op-by-op (eager, unrolled)
run do.  With the default, XLA's fusions skip bf16 roundings, the router
sees other inputs and routes other tokens: at qwen3-moe's ``REDUCED``
(the weights of the reference's eager ``transformer_init`` with key 0,
tokens as below) the reference's default compile gives aux 2.116575,
its op-by-op run 2.1102488, the port 2.1102490, and its default and
op-by-op logits differ by 2.78 (the bound is 2.87); compiled exactly, the
port's logits equal the reference's and the loss is the same f32 value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x7b as j_mixtral
from repro.configs import qwen3_moe_30b_a3b as j_qwen3_moe
from repro.models import moe as j_moe
from repro.models.common import count_params as j_count_params
from repro.models.transformer import (
    lm_loss as j_lm_loss, transformer_apply as j_apply,
    transformer_init as j_init,
)

from repro_torch import interop
from repro_torch.configs import mixtral_8x7b as t_mixtral
from repro_torch.configs import qwen3_moe_30b_a3b as t_qwen3_moe
from repro_torch.models.common import count_params, for_serving
from repro_torch.models.moe import MoE, MoEConfig, capacity
from repro_torch.models.transformer import lm_loss, transformer_apply
from repro_torch.testing.shared import SharedParts
from repro_torch.train.step import trainable_params

# (MoE config, batch, tokens a row)
CASES = {
    "plain": (dict(d_model=32, d_ff=48, n_experts=4, top_k=2), 2, 16),
    # S = 64 at E = 4, top-2 and half the capacity: C = 16 of an average
    # load of 32 assignments an expert, so most experts drop
    "drops": (dict(d_model=32, d_ff=48, n_experts=4, top_k=2,
                   capacity_factor=0.5), 2, 64),
    "top3-unnormed": (dict(d_model=24, d_ff=40, n_experts=8, top_k=3,
                           router_norm_topk=False), 3, 24),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _moe_pair(kw, dtype, seed=0):
    """The reference's MoE parameters and the port's layer holding them
    (experts rounded to ``dtype`` as a serving layer; router f32)."""
    jcfg = j_moe.MoEConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(j_moe.moe_init, static_argnums=1)(
            jax.random.key(seed), jcfg))
    layer = MoE(MoEConfig(**kw), dtype=dtype)
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(np.array(params["router"]["kernel"])))
        for n in ("wi", "wg", "wo"):
            getattr(layer, n).copy_(torch.from_numpy(np.array(params[n])))
    return jcfg, params, for_serving(layer)


def _exact(fn, params, cfg, *args):
    """``fn(params, cfg, *args)`` compiled with bf16 excess precision off."""
    compiled = jax.jit(fn, static_argnums=1).lower(params, cfg, *args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(params, *args)


def _reference_run(monkeypatch, jcfg, params, x):
    """The reference's (y, aux) and its ``tok_of_slot`` (B, E·C)."""
    def run(params, cfg, x):
        seen = []

        def record(a, *axes):
            seen.append(a)
            return a

        monkeypatch.setattr(j_moe, "constrain", record)
        return j_moe.moe_apply(params, cfg, x) + (seen[0],)

    y, aux, xe = _exact(run, params, jcfg, x)
    xe = np.asarray(xe.astype(jnp.float32))            # (B, E, C, D)
    xs = np.asarray(x.astype(jnp.float32))
    B, S, D = xs.shape
    xe = xe.reshape(B, -1, D)
    tok = np.full(xe.shape[:2], S, np.int64)
    for b in range(B):
        eq = (xe[b][:, None, :] == xs[b][None, :, :]).all(-1)   # (E·C, S)
        assert (eq.sum(1) <= 1).all(), "x rows must be distinct"
        tok[b] = np.where(eq.any(1), eq.argmax(1), S)
    return y, aux, tok


def _reference_idx(jcfg, params, x):
    logits = x.astype(jnp.float32) @ params["router"]["kernel"].astype(
        jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    jcfg.top_k)[1])


def _assert_same_routing(got_idx, want_idx, probs):
    if np.array_equal(got_idx, want_idx):
        return
    rows = np.argwhere((got_idx != want_idx).any(-1))
    gaps = []
    for b, s in rows:
        p = np.sort(probs[b, s])[::-1]
        gaps.append((int(b), int(s), float(np.abs(np.diff(p)).min())))
    raise AssertionError(f"routing flips at (row, token, smallest gap "
                         f"between router probabilities): {gaps}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_matches_reference(case, dtype, monkeypatch):
    kw, B, S = CASES[case]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg, params, layer = _moe_pair(kw, tdt)
    xn = np.random.default_rng(1).normal(size=(B, S, kw["d_model"])
                                         ).astype(np.float32)
    jx, tx = jnp.asarray(xn, jdt), torch.as_tensor(xn).to(tdt)
    want_y, want_aux, want_tok = _reference_run(monkeypatch, jcfg, params, jx)

    r = layer.route(tx)
    _assert_same_routing(r.idx.numpy(), _reference_idx(jcfg, params, jx),
                         r.probs.numpy())
    np.testing.assert_array_equal(r.tok_of_slot.numpy(), want_tok)
    C, E, K = capacity(layer.cfg, S), kw["n_experts"], kw["top_k"]
    kept = (want_tok < S).reshape(B, E, C).sum(-1)
    np.testing.assert_array_equal(
        (r.tok_of_slot < S).reshape(B, E, C).sum(-1).numpy(), kept)
    np.testing.assert_array_equal(r.counts.clamp(max=C).numpy(), kept)

    y, aux = layer(tx)
    want_dropped = B * S * K - int(kept.sum())
    assert int(layer.last_dropped) == want_dropped
    assert (want_dropped > 0) == (case == "drops")
    assert y.dtype == tdt and y.shape == (B, S, kw["d_model"])
    got, want = y.float().numpy(), np.asarray(want_y, np.float32)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    else:
        np.testing.assert_array_less(
            np.abs(got - want), 2 * 2 ** -8 * np.abs(want) + 2 ** -8 * scale)
    np.testing.assert_array_max_ulp(np.float32(aux.item()),
                                    np.float32(want_aux), maxulp=2)
    # deterministic: a second call gives the same bytes
    assert torch.equal(layer(tx)[0], y)


@pytest.mark.parametrize("S,want", [(1, 8), (1024, None), (7, None)])
def test_capacity_matches_reference(S, want):
    for kw in (dict(n_experts=128, top_k=8), dict(n_experts=8, top_k=2),
               dict(n_experts=4, top_k=2, capacity_factor=0.5)):
        t = capacity(MoEConfig(d_model=8, d_ff=8, **kw), S)
        assert t == j_moe.capacity(j_moe.MoEConfig(d_model=8, d_ff=8, **kw), S)
        assert want is None or t == want
    # the serving phases' capacities (qwen3-moe, mixtral at a 1 024 prompt)
    assert capacity(t_qwen3_moe.CONFIG.moe_cfg, 1024) == 80
    assert capacity(t_mixtral.CONFIG.moe_cfg, 1024) == 320


# ---------------------------------------------------------------------------
# the MoE archs' reduced models
# ---------------------------------------------------------------------------

ARCHS = {"qwen3-moe-30b-a3b": (j_qwen3_moe, t_qwen3_moe),
         "mixtral-8x7b": (j_mixtral, t_mixtral)}
B_, S_ = 2, 16


def _arch_base(name):
    jcfg = ARCHS[name][0].REDUCED
    params = jax.jit(j_init, static_argnums=1)(jax.random.key(0), jcfg)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (B_, S_ + 1)).astype(np.int32)
    return dict(tree=jax.tree_util.tree_map(np.asarray, params),
                tokens=toks[:, :-1], targets=toks[:, 1:],
                n_params=j_count_params(params))


def _arch_forward(name, ref):
    logits, aux = _exact(j_apply, _jnp(ref["tree"]), ARCHS[name][0].REDUCED,
                         jnp.asarray(ref["tokens"]))
    return dict(logits=np.asarray(logits, np.float32), aux=float(aux))


def _arch_grads(name, ref):
    loss, grads = _exact(jax.value_and_grad(j_lm_loss), _jnp(ref["tree"]),
                         ARCHS[name][0].REDUCED, jnp.asarray(ref["tokens"]),
                         jnp.asarray(ref["targets"]))
    return dict(loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_ref(request, tmp_path_factory):
    """Each part once for the test session (`SharedParts`)."""
    name = request.param
    return name, SharedParts(tmp_path_factory, f"torch-moe-{name}", {
        "base": (("tree", "tokens", "targets", "n_params"),
                 lambda ref: _arch_base(name)),
        "forward": (("logits", "aux"), lambda ref: _arch_forward(name, ref)),
        "grads": (("loss", "grads"), lambda ref: _arch_grads(name, ref))})


def test_arch_logits_and_aux_match_reference(arch_ref):
    name, ref = arch_ref
    cfg = ARCHS[name][1].REDUCED
    model = interop.transformer_params_from_numpy(ref["tree"], cfg)
    logits, aux = transformer_apply(model, torch.as_tensor(ref["tokens"]).long())
    got, want = logits.float().numpy(), ref["logits"]
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max() + 0.05
    np.testing.assert_array_max_ulp(np.float32(aux.item()),
                                    np.float32(ref["aux"]), maxulp=2)
    assert float(aux) > 0
    assert count_params(model) == ref["n_params"]


def test_arch_loss_and_grads_match_reference(arch_ref):
    name, ref = arch_ref
    cfg = ARCHS[name][1].REDUCED
    model = interop.transformer_params_from_numpy(ref["tree"], cfg, train=True)
    toks, tgts = (torch.as_tensor(ref[k]).long() for k in ("tokens", "targets"))
    loss = lm_loss(model, toks, tgts)
    assert loss.item() == pytest.approx(ref["loss"], rel=1e-3)
    params = trainable_params(model)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for entry in interop.param_entries(model):
        want = interop._read(ref["grads"], entry)
        got = grads[entry[0]].numpy()
        assert got.shape == want.shape, entry[0]
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max(), entry[0]
    # the aux loss reaches the router: its gradient alone is nonzero there,
    # and the loss without it gives the router another gradient
    routers = [blk.moe.router for blk in model.layers]
    _, aux = transformer_apply(model, toks)
    assert all(float(g.abs().max()) > 0
               for g in torch.autograd.grad(aux, routers))
    no_aux = torch.autograd.grad(lm_loss(model, toks, tgts, aux_weight=0.0),
                                 routers)
    assert all(not torch.equal(grads[f"layers.{i}.moe.router"], g)
               for i, g in enumerate(no_aux))


def test_moe_params_round_trip_through_interop(arch_ref):
    name, ref = arch_ref
    cfg = ARCHS[name][1].REDUCED
    model = interop.transformer_params_from_numpy(ref["tree"], cfg, train=True)
    back = interop.params_to_numpy(model, ref["tree"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, ref["tree"])
    served = interop.transformer_params_from_numpy(ref["tree"], cfg)
    blk = served.layers[0].moe
    assert blk.router.dtype == torch.float32
    assert {getattr(blk, n).dtype for n in ("wi", "wg", "wo")} == {cfg.dtype}
    np.testing.assert_array_equal(blk.router.numpy(),
                                  ref["tree"]["layers"]["moe"]["router"]
                                  ["kernel"][0])
