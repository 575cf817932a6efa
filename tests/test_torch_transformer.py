"""The port's model layers and transformer against the JAX reference, on the CPU.

Weights are the reference's own (``transformer_init`` with a JAX key),
carried into the port by ``repro_torch.interop.transformer_params_from_numpy``;
tokens come from a numpy seed.  Geometry: the reference's ``TINY`` config
(``tests/models/test_transformer.py``) and its variants, ``moe`` with the
reference's capacity factor 8.0 (no token dropped, so decode equals the
forward), and the dense archs' ``REDUCED`` configs.  Each worker draws a
config's reference weights once (`_j_params`) and runs the reference's
decode step compiled once a config (`_j_decode`); its init is compiled
too, one program instead of one per op.

Tolerances:
  * building blocks on the same inputs: equal, or within f32 rounding
    (1e-6) where the two frameworks' elementwise functions differ by an ulp;
  * whole models with ``dtype=float32`` (projections still bf16): atol 1e-4,
    rtol 1e-5, f32 summation order;
  * whole models in bf16 against the reference: the reference's own bound
    for two runs that round differently, ``max|a − b| ≤ 0.02·max|b| + 0.05``
    (``test_chunked_equals_dense_end_to_end``).  An elementwise bound does
    not hold: the reference's scanned stack is compiled as one program
    whose fusions skip some bf16 roundings, so one residual element moved
    by one unit in the last place shifts every logit by a share of the
    logit scale — on these inputs the reference's own scanned and unrolled
    logits differ past its decode-vs-forward tolerance;
  * the port's decode against its own forward: the reference's own
    decode-vs-forward tolerance, atol 0.15, rtol 0.1.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_27b as j_gemma2
from repro.configs import minitron_4b as j_minitron
from repro.models import common as jcommon
from repro.models.transformer import (
    TransformerConfig as JConfig, init_decode_cache as j_cache,
    lm_loss as j_loss, transformer_apply as j_apply,
    transformer_decode as j_decode, transformer_init as j_init,
)

from repro_torch.configs import gemma2_27b as t_gemma2
from repro_torch.configs import minitron_4b as t_minitron
from repro_torch.interop import (
    transformer_config_from, transformer_params_from_numpy,
)
from repro_torch.models import common as tcommon
from repro_torch.models.transformer import (
    Transformer, init_decode_cache, lm_loss, transformer_apply,
    transformer_decode, transformer_init,
)

TINY = JConfig(
    name="tiny", vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=8, d_ff=64, remat=False)

VARIANTS = {
    "dense": TINY,
    "chunked": dataclasses.replace(TINY, attn_impl="chunked", q_chunk=4,
                                   kv_chunk=4),
    "gemma2ish": dataclasses.replace(
        TINY, local_global=True, window=6, n_layers=4, attn_softcap=50.0,
        final_softcap=30.0),
    "window": dataclasses.replace(TINY, window=5),
    "moe": dataclasses.replace(TINY, d_ff=0, n_experts=4, top_k=2,
                               moe_d_ff=32, moe_capacity_factor=8.0),
}
DECODE_TOL = dict(atol=0.15, rtol=0.1)
F32_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _j_params(jcfg, seed):
    return jax.jit(j_init, static_argnums=1)(jax.random.key(seed), jcfg)


_j_decode = jax.jit(j_decode, static_argnums=1)


def _pair(jcfg, seed=0):
    """The reference's parameters and the port's model holding them."""
    params = _j_params(jcfg, seed)
    model = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        transformer_config_from(jcfg))
    return params, model


def _close_to_reference(got, want, dtype="bfloat16"):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max() + 0.05


def _toks(vocab, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_common_blocks_match_reference(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 12, 4, 16)) * 3).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    tol = 0 if dtype == "bfloat16" else 1e-6

    got = tcommon.rmsnorm_apply(torch.as_tensor(scale), tx)
    want = jcommon.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)

    pos = np.arange(12)[None].repeat(2, 0)
    cos, sin = tcommon.rotary_embedding(torch.as_tensor(pos), 16, 1e6)
    jcos, jsin = jcommon.rotary_embedding(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(_np(cos), _np(jcos), atol=1e-6)
    np.testing.assert_allclose(_np(sin), _np(jsin), atol=1e-6)
    got = tcommon.apply_rope(tx, cos, sin)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(jcommon.apply_rope(jx, jcos, jsin)),
                               atol=tol, rtol=tol)

    np.testing.assert_allclose(_np(tcommon.softcap(tx * 20, 30.0)),
                               _np(jcommon.softcap(jx * 20, 30.0)),
                               atol=10 * tol, rtol=tol)
    assert tcommon.softcap(tx, None) is tx

    W = rng.normal(size=(16, 24)).astype(np.float32)
    dense = tcommon.for_serving(tcommon.Dense(16, 24))
    with torch.no_grad():
        dense.weight.copy_(torch.as_tensor(W.T.copy()))
    got = dense(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(got), _np(jcommon.dense_apply({"kernel": jnp.asarray(W)}, jx)))


def test_embedding_lookup_matches_reference():
    table = np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32)
    ids = _toks(64)
    want = jcommon.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(ids))
    got = tcommon.embed_apply(torch.as_tensor(table), torch.as_tensor(ids).long())
    np.testing.assert_array_equal(_np(got), _np(want))


def test_weights_carried_over_with_bf16_rounding():
    # the port stores dense weights (out, in) in bf16: exactly the
    # reference's kernel cast to bf16 as every dense_apply casts it
    jcfg = VARIANTS["gemma2ish"]
    params, model = _pair(jcfg)
    for i, blk in enumerate(model.layers):
        p = params["layers"]["local" if i % 2 == 0 else "global"]
        for name in ("wq", "wk", "wv", "wo"):
            want = np.asarray(p["attn"][name]["kernel"][i // 2]
                              .astype(jnp.bfloat16), np.float32).T
            np.testing.assert_array_equal(
                _np(getattr(blk.attn, name).weight), want)
        np.testing.assert_array_equal(
            _np(blk.ln_attn.scale), np.asarray(p["ln_attn"]["scale"][i // 2]))
        assert blk.attn.cfg.window == (6 if i % 2 == 0 else None)
    assert model.embed.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_apply_matches_reference(impl, dtype):
    jcfg = dataclasses.replace(VARIANTS[impl], dtype=getattr(jnp, dtype))
    params, model = _pair(jcfg, seed=1)
    toks = _toks(jcfg.vocab, 2, 16)
    want = j_apply(params, jcfg, jnp.asarray(toks))[0]
    got, aux = transformer_apply(model, torch.as_tensor(toks).long())
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 16, 64)
    assert float(aux) == 0.0
    _close_to_reference(got, want, dtype)


@pytest.mark.parametrize("variant", ["dense", "gemma2ish", "window", "moe"])
def test_decode_matches_forward_and_reference(variant):
    """Token-by-token decode with the KV cache == the full forward, and
    == the reference's decode."""
    jcfg = VARIANTS[variant]
    params, model = _pair(jcfg)
    B, S = 2, 12
    toks = _toks(jcfg.vocab, B, S)
    full, _ = transformer_apply(model, torch.as_tensor(toks).long())
    cache = init_decode_cache(model.cfg, B, S)
    jc = j_cache(jcfg, B, S)
    got, want = [], []
    for i in range(S):
        logits, cache = transformer_decode(
            model, cache, torch.as_tensor(toks[:, i:i + 1]).long(),
            torch.full((B,), i))
        got.append(_np(logits[:, 0]))
        jl, jc = _j_decode(params, jcfg, jc, jnp.asarray(toks[:, i:i + 1]),
                           jnp.full((B,), i, jnp.int32))
        want.append(_np(jl[:, 0]))
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, _np(full), **DECODE_TOL)
    _close_to_reference(got, want)
    if jcfg.window is not None:   # rolling buffers hold only the window
        assert min(c["k"].shape[1] for c in cache) == jcfg.window


@pytest.mark.parametrize("variant", ["dense", "gemma2ish", "window", "moe"])
def test_prefill_fills_cache_as_decode_does(variant):
    """A prefill given a cache leaves it as S decode steps would (rolling
    buffers: the last ``window`` positions), and decoding goes on from it
    as from the replayed cache.  The prefill projects all S rows at once,
    which can move a bf16 element by one unit in the last place."""
    cfg = transformer_config_from(VARIANTS[variant])
    model = transformer_init(cfg, torch.Generator().manual_seed(2))
    B, S, extra = 2, 11, 3
    toks = torch.as_tensor(_toks(cfg.vocab, B, S + extra, seed=6)).long()
    filled = init_decode_cache(cfg, B, S + extra)
    transformer_apply(model, toks[:, :S], filled)
    replayed = init_decode_cache(cfg, B, S + extra)
    for i in range(S):
        transformer_decode(model, replayed, toks[:, i:i + 1], torch.full((B,), i))
    for a, b in zip(filled, replayed):
        torch.testing.assert_close(a["k"], b["k"], atol=0, rtol=2 ** -7)
        torch.testing.assert_close(a["v"], b["v"], atol=0, rtol=2 ** -7)
    for i in range(S, S + extra):
        la, _ = transformer_decode(model, filled, toks[:, i:i + 1],
                                   torch.full((B,), i))
        lb, _ = transformer_decode(model, replayed, toks[:, i:i + 1],
                                   torch.full((B,), i))
        np.testing.assert_allclose(_np(la), _np(lb), **DECODE_TOL)


def test_prefill_longer_than_cache_raises():
    cfg = transformer_config_from(TINY)
    model = transformer_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cannot take"):
        transformer_apply(model, torch.zeros(1, 9, dtype=torch.long),
                          init_decode_cache(cfg, 1, 8))


def test_decode_cache_written_in_place():
    cfg = transformer_config_from(TINY)
    model = transformer_init(cfg, torch.Generator().manual_seed(0))
    cache = init_decode_cache(cfg, 2, 8)
    before = [c["k"].data_ptr() for c in cache]
    _, out = transformer_decode(model, cache, torch.zeros(2, 1, dtype=torch.long),
                                torch.tensor([0, 3]))
    assert out is cache and [c["k"].data_ptr() for c in out] == before
    k0 = cache[0]["k"]
    assert k0[0, 0].abs().sum() > 0 and k0[1, 3].abs().sum() > 0
    assert k0[0, 1:].abs().sum() == 0 and k0[1, :3].abs().sum() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_matches_reference(dtype):
    jcfg = dataclasses.replace(TINY, dtype=getattr(jnp, dtype))
    params, model = _pair(jcfg, seed=3)
    toks, targets = _toks(jcfg.vocab, 2, 16, seed=4), _toks(jcfg.vocab, 2, 16, seed=5)
    want = float(j_loss(params, jcfg, jnp.asarray(toks), jnp.asarray(targets)))
    got = float(lm_loss(model, torch.as_tensor(toks).long(),
                        torch.as_tensor(targets).long()))
    # the f32 config's projections still run in bf16: one rounding that
    # flips upstream moves the mean loss by ~2e-5 relative
    rtol = 1e-4 if dtype == "float32" else 1e-3
    assert got == pytest.approx(want, rel=rtol)


@pytest.mark.parametrize("variant", ["dense", "gemma2ish", "moe"])
def test_count_params_matches_reference(variant):
    jcfg = VARIANTS[variant]
    params, model = _pair(jcfg)
    actual = tcommon.count_params(model)
    assert actual == jcommon.count_params(params)
    assert model.cfg.param_count() == jcfg.param_count()
    assert abs(actual - model.cfg.param_count()) / actual < 0.05


def test_moe_blocks_hold_moe_in_place_of_ffn():
    cfg = transformer_config_from(VARIANTS["moe"])
    model = Transformer(cfg)
    for blk in model.layers:
        assert hasattr(blk, "moe") and not hasattr(blk, "ffn")
        assert blk.moe.cfg == cfg.moe_cfg
    assert not hasattr(transformer_init(transformer_config_from(TINY),
                                        torch.Generator()).layers[0], "moe")
    # a serving model rounds the experts, never the f32 router
    served = transformer_init(cfg, torch.Generator().manual_seed(0))
    moe = served.layers[0].moe
    assert moe.router.dtype == torch.float32 and moe.wi.dtype == cfg.dtype


@pytest.mark.parametrize("variant", ["dense", "gemma2ish", "moe"])
def test_serving_init_equals_for_serving_of_training_init(variant):
    """The serving model, built layer by layer from the meta device, holds
    the same draws as the training model rounded by `for_serving`."""
    cfg = transformer_config_from(dataclasses.replace(VARIANTS[variant],
                                                      qk_norm=True))
    served = transformer_init(cfg, torch.Generator().manual_seed(5))
    want = tcommon.for_serving(transformer_init(
        cfg, torch.Generator().manual_seed(5), train=True))
    got = dict(served.named_parameters())
    assert list(got) == [n for n, _ in want.named_parameters()]
    for name, p in want.named_parameters():
        assert got[name].device.type == "cpu" and not got[name].requires_grad
        assert got[name].dtype == p.dtype and torch.equal(got[name], p), name


DENSE_ARCHS = {"gemma2-27b": (j_gemma2, t_gemma2),
               "minitron-4b": (j_minitron, t_minitron)}


@pytest.mark.parametrize("arch", list(DENSE_ARCHS))
def test_dense_arch_reduced_logits_match_reference(arch):
    """The reference compiled with XLA's ``xla_allow_excess_precision`` off
    (an option of that one compile), so that its scanned stack rounds
    every bf16 op as written, as the port does.  With the default its
    fusions skip roundings: at gemma2-27b's ``REDUCED`` its logits then
    differ from its own op-by-op (eager, unrolled) run's by 0.656, past the
    bound (0.650); the port is 0.125 (one bf16 unit at |logit| 16–32) from
    either the op-by-op run or the exact compile."""
    j_mod, t_mod = DENSE_ARCHS[arch]
    jcfg = j_mod.REDUCED
    params = jax.jit(j_init, static_argnums=1)(jax.random.key(0), jcfg)
    model = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), t_mod.REDUCED)
    toks = _toks(jcfg.vocab, 2, 24)     # longer than the local window (16)
    want, want_aux = jax.jit(j_apply, static_argnums=1).lower(
        params, jcfg, jnp.asarray(toks)).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        params, jnp.asarray(toks))
    got, aux = transformer_apply(model, torch.as_tensor(toks).long())
    assert got.shape == (2, 24, jcfg.vocab)
    _close_to_reference(got, want)
    assert float(aux) == float(want_aux) == 0.0
    assert tcommon.count_params(model) == jcommon.count_params(params)
