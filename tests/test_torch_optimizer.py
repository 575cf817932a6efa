"""The port's AdamW, step guard, heartbeat and token stream against the JAX
reference, on the CPU.

Inputs come from a numpy seed and go to both packages as the same f32
arrays.  Tolerances:
  * `schedule`, the bias corrections and `global_norm` are f32 in both
    packages: within 2 units in the last place (rtol 2.5e-7), since XLA's
    and PyTorch's ``cos``, ``pow`` and reduction order may each move one;
  * three AdamW updates on identical grads: params, moments and step
    within rtol 2e-6, atol 1e-7 (f32 rounding of the same expressions,
    three times; the update divides by sqrt(v), which doubles a relative
    error);
  * the token stream: equal, draw for draw.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import token_stream as j_token_stream
from repro.train import elastic as j_elastic
from repro.train import optimizer as j_opt

from repro_torch.data.synthetic import token_stream
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.train import elastic, optimizer as t_opt

RTOL, ATOL = 2e-6, 1e-7

SHAPES = {"w": (7, 5), "b": (5,), "emb": (33, 4), "scale": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(scale * rng.normal(size=s), np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got: dict, want, rtol=RTOL, atol=ATOL):
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_matches_reference(step):
    # warm-up (< 10), the switch at 10, cosine decay, the end and past it
    cfg = j_opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    tcfg = t_opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                             min_lr_ratio=0.1)
    want = float(j_opt.schedule(cfg, jnp.int32(step)))
    got = t_opt.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=2.5e-7)


def test_global_norm_matches_reference():
    tree = _tree(1)
    want = float(j_opt.global_norm(_j(tree)))
    got = t_opt.global_norm(_t(tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=2.5e-7)
    assert abs(float(t_opt.global_norm({"a": torch.tensor([3.0]),
                                        "b": torch.tensor([4.0])})) - 5) < 1e-6


@pytest.mark.parametrize("grad_scale,clip", [(1.0, 1.0), (1e3, 1.0),
                                             (0.01, 1.0), (1.0, 100.0)])
def test_adamw_three_updates_match_reference(grad_scale, clip):
    # grad_scale 1e3 clips every step (global norm far above the clip),
    # 0.01 and clip 100 never do; weight decay acts on every leaf
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
               weight_decay=0.1)
    jcfg, tcfg = j_opt.AdamWConfig(**cfg), t_opt.AdamWConfig(**cfg)
    params = _tree(0)
    jp, jstate = _j(params), j_opt.adamw_init(_j(params))
    tp = _t(params)
    tstate = t_opt.adamw_init(tp)
    for i in range(3):
        grads = _tree(10 + i, grad_scale)
        jp, jstate = j_opt.adamw_update(jcfg, _j(grads), jstate, jp)
        tp, tstate = t_opt.adamw_update(tcfg, _t(grads), tstate, tp)
        _close(tp, jp)
        _close(tstate.mu, jstate.mu)
        _close(tstate.nu, jstate.nu)
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert tstate.step.dtype == torch.int32


def test_adamw_clips_first_step_to_lr():
    # the reference's own check: a huge grad moves each weight by ≈ lr
    cfg = t_opt.AdamWConfig(lr=1e-3, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = t_opt.adamw_init(params)
    t_opt.adamw_update(cfg, {"w": torch.full((4,), 1e6)}, state, params)
    assert float(params["w"].abs().max()) < 2 * cfg.lr


def test_adamw_in_slices_equals_whole(monkeypatch):
    cfg = t_opt.AdamWConfig(lr=1e-2, warmup_steps=1)
    whole, sliced = _t(_tree(0)), _t(_tree(0))
    s_whole, s_sliced = t_opt.adamw_init(whole), t_opt.adamw_init(sliced)
    for i in range(2):
        grads = _t(_tree(20 + i))
        t_opt.adamw_update(cfg, grads, s_whole, whole)
        monkeypatch.setattr(adamw_ops, "CHUNK", 7)
        t_opt.adamw_update(cfg, grads, s_sliced, sliced)
        monkeypatch.setattr(adamw_ops, "CHUNK", 1 << 26)
    for k in SHAPES:
        assert torch.equal(whole[k], sliced[k])
        assert torch.equal(s_whole.mu[k], s_sliced.mu[k])
        assert torch.equal(s_whole.nu[k], s_sliced.nu[k])


def test_adamw_minimizes_quadratic():
    cfg = t_opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = t_opt.adamw_init(params)
    for _ in range(150):
        t_opt.adamw_update(cfg, {"w": 2 * params["w"]}, state, params)
    assert float(params["w"].square().sum()) < 1e-3
    assert int(state.step) == 150


@pytest.mark.parametrize("start", [0, 3])
def test_token_stream_equals_reference(start):
    want = j_token_stream(97, 3, 9, seed=5, start_step=start)
    got = token_stream(97, 3, 9, seed=5, start_step=start)
    for _ in range(3):
        (jt, jg), (tt, tg) = next(want), next(got)
        assert tt.dtype == np.int32
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tt[:, 1:], tg[:, :-1])


def test_token_stream_is_zipf():
    toks, _ = next(token_stream(1000, 64, 128, seed=0))
    counts = np.bincount(toks.ravel(), minlength=1000)
    # p ∝ 1/rank: the first id is drawn about twice as often as the second
    assert counts[0] > counts[1] > counts[10] > counts[500]


@pytest.mark.parametrize("mod", [j_elastic, elastic], ids=["jax", "torch"])
def test_step_guard_raises_past_budget(mod):
    with pytest.raises(mod.StragglerTimeout):
        with mod.StepGuard(0.05):
            time.sleep(2)
    with mod.StepGuard(0.0):            # no budget: never fires
        time.sleep(0.01)
    with mod.StepGuard(5.0):            # within budget: the timer is cleared
        pass
    time.sleep(0.01)


def test_uninterruptible_defers_the_guard():
    done = []
    with pytest.raises(elastic.StragglerTimeout):
        with elastic.StepGuard(0.05):
            with elastic.uninterruptible():
                time.sleep(0.2)         # the timer expires in here
                done.append(1)
    assert done == [1]


@pytest.mark.parametrize("mod", [j_elastic, elastic], ids=["jax", "torch"])
def test_heartbeat_file(tmp_path, mod):
    hb = mod.HeartbeatFile(tmp_path / "sub" / "hb")
    assert hb.age_s() is None
    hb.beat(7)
    assert hb.path.read_text().split()[0] == "7"
    assert 0 <= hb.age_s() < 60
