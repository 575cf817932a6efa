"""The port's flash attention against the JAX reference, on the CPU.

On a CPU tensor ``repro_torch.kernels.flash_attention.ops.flash_attention``
is the plain version (``ref.py``); it must agree with the reference's
oracle ``flash_attention_ref`` and with the reference's Pallas kernel in
interpret mode, on the cases and tolerances of
``tests/kernels/test_kernels.py`` (bf16 2e-2, f32 1e-5; window and softcap
2e-5).  Inputs are made with numpy from a seed and rounded to the working
dtype the same way in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.flash_attention.ops import flash_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.as_tensor(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 64, 2, 2, 16),
    (2, 128, 4, 2, 32),
    (1, 256, 8, 4, 16),
    (2, 64, 4, 1, 64),     # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_shapes_match_reference(B, S, H, KV, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(7, B, S, H, KV, hd), dtype)
    got = flash_attention(tq, tk, tv)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    _close(got, j_ref(jq, jk, jv), tol)
    _close(got, j_flash(jq, jk, jv, bq=64, bk=64, interpret=True), tol)


@pytest.mark.parametrize("window", [16, 64])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_flash_window_softcap_match_reference(window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(0, 2, 128, 4, 2, 32), "float32")
    got = flash_attention(tq, tk, tv, window=window, softcap=softcap)
    _close(got, j_ref(jq, jk, jv, window=window, softcap=softcap), 2e-5)
    _close(got, j_flash(jq, jk, jv, window=window, softcap=softcap, bq=32,
                        bk=64, interpret=True), 2e-5)


@pytest.mark.parametrize("S,causal,window", [
    (100, True, None), (100, True, 16), (77, False, None), (77, False, 8)])
def test_flash_ragged_and_non_causal_match_reference(S, causal, window):
    # S is not a multiple of any block: the port takes any S (the card
    # kernel masks the ragged tail; tests/test_torch_gpu.py holds it there)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(3, 2, S, 4, 2, 16), "float32")
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(got, j_ref(jq, jk, jv, causal=causal, window=window), 1e-5)


def test_flash_output_dtype_and_layout():
    _, (tq, tk, tv) = _both(_inputs(1, 2, 32, 4, 2, 16), "bfloat16")
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape


def test_flash_other_devices_raise():
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("bad,match", [("cpu tensor", "CUDA tensor"),
                                       ("head_dim", "head_dim"),
                                       ("kv rows", "multiple")])
def test_flash_kernel_wrapper_rejects_before_launch(bad, match):
    # the CUDA wrapper validates its inputs before it builds or launches
    # anything, so these raise here, where there is no card and no nvcc
    q = torch.zeros(4, 64, 16)
    k = v = torch.zeros(2, 64, 16)
    if bad == "head_dim":
        q, k, v = (t.new_zeros(t.shape[0], 64, 24) for t in (q, k, v))
    if bad == "kv rows":
        k = v = torch.zeros(3, 64, 16)
    with pytest.raises(ValueError, match=match):
        flash_attention_bhsd(q, k, v)
    assert flash_attention_bhsd.launches == 0
