"""The port's mIS updates against the JAX reference, on the CPU.

Bitmaps cross between the packages through `repro_torch.interop` (the
reference's uint32 words ↔ the port's int32 words, same bits).  Greedy:
bitmap and count equal to ``repro.core.mis.mis_greedy_update`` and to the
reference's Pallas kernel in interpret mode, with τ cut mid-table, state
carried across calls and a stacked pattern axis; and on the adversarial
cases the card tests hold the kernel to (`parity.MIS_EDGE_CASES`: long
conflict chains, one shared vertex, duplicate vertices in a row, τ cut
inside a batch, count ≥ τ at entry, n_valid ≤ 0 and > cap, k = 1 and 16).
Luby: count equal, and the whole set (bitmap) equal when run to completion.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mis as jmis
from repro.kernels.mis_bitmap.kernel import mis_bitmap_select as j_pallas_mis

from repro_torch import interop
from repro_torch.core import mis as tmis
from repro_torch.kernels.mis_bitmap.ops import mis_greedy_update_kernel
from repro_torch.testing.parity import MIS_EDGE_CASES, mis_edge_inputs

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _tables(seed, P, n, cap, K, k):
    """(P, cap, K) rows of k distinct vertices (−1 past n_valid and past
    column k), n_valid (P,), from a numpy seed; rows collide often."""
    rng = np.random.default_rng(seed)
    emb = np.full((P, cap, K), -1, np.int32)
    nv = rng.integers(cap // 2, cap + 1, P).astype(np.int32)
    for p in range(P):
        for r in range(nv[p]):
            emb[p, r, :k] = rng.choice(n, k, replace=False)
    return emb, nv


def _ref_greedy(bm, cnt, emb, nv, tau, k):
    """Reference per pattern → ((P, Nw) uint32, (P,) int)."""
    out_bm, out_cnt = [], []
    for p in range(emb.shape[0]):
        b, c = jmis.mis_greedy_update(jnp.asarray(bm[p]), jnp.int32(cnt[p]),
                                      jnp.asarray(emb[p]), jnp.int32(nv[p]),
                                      jnp.int32(tau[p]), k)
        out_bm.append(np.asarray(b))
        out_cnt.append(int(c))
    return np.stack(out_bm), np.asarray(out_cnt)


@pytest.mark.parametrize("seed,P,n,k,taus", [
    (0, 1, 300, 2, [INT32_MAX]),
    (1, 3, 500, 3, [5, INT32_MAX, 40]),    # τ cut mid-table
    (2, 4, 97, 4, [1, 3, INT32_MAX, 9]),   # n not a multiple of 32
])
def test_greedy_equals_reference_with_carry(seed, P, n, k, taus):
    cap, K = 128, k + 1
    Nw = jmis.bitmap_words(n)
    j_bm, j_cnt = np.zeros((P, Nw), np.uint32), np.zeros(P, np.int64)
    t_bm = interop.bitmap_from_uint32(j_bm)
    t_cnt = torch.zeros(P, dtype=torch.int32)
    tau = np.asarray(taus, np.int64)
    for call in range(2):   # bitmap and count carry across calls
        emb, nv = _tables(seed * 10 + call, P, n, cap, K, k)
        j_bm, j_cnt = _ref_greedy(j_bm, j_cnt, emb, nv, tau, k)
        t_bm, t_cnt = mis_greedy_update_kernel(
            t_bm, t_cnt, torch.as_tensor(emb), torch.as_tensor(nv),
            torch.as_tensor(tau.astype(np.int32)), k)
        np.testing.assert_array_equal(j_bm, interop.bitmap_to_uint32(t_bm))
        np.testing.assert_array_equal(j_cnt, t_cnt.numpy())
    if taus[0] != INT32_MAX:
        assert int(t_cnt[0]) == taus[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_equals_pallas_interpret(seed):
    P, n, cap, k = 2, 200, 64, 3
    emb, nv = _tables(seed, P, n, cap, k, k)
    bm0 = np.zeros((P, jmis.bitmap_words(n)), np.uint32)
    bm0[:, 0] = 0x80000001      # pre-set bits, including bit 31
    tau = np.array([7, INT32_MAX], np.int32)
    t_bm, t_cnt = tmis.mis_greedy_update(
        interop.bitmap_from_uint32(bm0), torch.tensor([2, 0], dtype=torch.int32),
        torch.as_tensor(emb), torch.as_tensor(nv), torch.as_tensor(tau), k)
    for p in range(P):
        b, c = j_pallas_mis(jnp.asarray(bm0[p]), jnp.int32([2, 0][p]),
                            jnp.asarray(emb[p]), jnp.int32(nv[p]),
                            jnp.int32(tau[p]), k=k, block_rows=32,
                            interpret=True)
        np.testing.assert_array_equal(np.asarray(b),
                                      interop.bitmap_to_uint32(t_bm[p]))
        assert int(c) == int(t_cnt[p])


@pytest.mark.parametrize("name", MIS_EDGE_CASES)
def test_greedy_edge_cases_equal_reference(name):
    """Bit for bit against the reference's Pallas kernel in interpret mode
    (it ORs each vertex's bit in turn) and, where every row holds distinct
    vertices, against its ``lax.scan`` (whose add-as-OR assumes them)."""
    c = mis_edge_inputs(name)
    k = c["k"]
    t_bm, t_cnt = mis_greedy_update_kernel(
        *(torch.as_tensor(c[f]) for f in ("bitmap", "count", "emb", "n_valid",
                                          "tau")), k)
    t_bm = interop.bitmap_to_uint32(t_bm)
    for p in range(c["emb"].shape[0]):
        args = (jnp.asarray(c["bitmap"][p].view(np.uint32)),
                jnp.int32(c["count"][p]), jnp.asarray(c["emb"][p]),
                jnp.int32(c["n_valid"][p]), jnp.int32(c["tau"][p]))
        b, n = j_pallas_mis(*args, k=k, block_rows=256, interpret=True)
        np.testing.assert_array_equal(np.asarray(b), t_bm[p])
        assert int(n) == int(t_cnt[p])
        if c["distinct"]:
            b, n = jmis.mis_greedy_update(*args, k)
            np.testing.assert_array_equal(np.asarray(b), t_bm[p])
            assert int(n) == int(t_cnt[p])
    if name == "one-vertex":       # one take, none past the preset bit
        assert t_cnt.tolist() == [1, 1, 5]
    if name == "tau-in-batch":
        assert t_cnt.tolist() == c["tau"].tolist()


@pytest.mark.parametrize("seed,taus", [
    (0, [INT32_MAX, INT32_MAX]), (1, [4, INT32_MAX]), (2, [30, 1]),
])
def test_luby_equals_reference(seed, taus):
    P, n, cap, k = 2, 150, 96, 3
    emb, nv = _tables(seed, P, n, cap, k, k)
    tau = np.asarray(taus, np.int32)
    t_bm, t_cnt = tmis.mis_luby_update(
        torch.zeros((P, tmis.bitmap_words(n)), dtype=torch.int32),
        torch.zeros(P, dtype=torch.int32), torch.as_tensor(emb),
        torch.as_tensor(nv), torch.as_tensor(tau), k, n)
    for p in range(P):
        b, c = jmis.mis_luby_update(jmis.bitmap_init(n), jnp.int32(0),
                                    jnp.asarray(emb[p]), jnp.int32(nv[p]),
                                    jnp.int32(tau[p]), k, n)
        assert int(c) == int(t_cnt[p])
        np.testing.assert_array_equal(np.asarray(b),
                                      interop.bitmap_to_uint32(t_bm[p]))
    if taus[0] == INT32_MAX:
        # run to completion, Luby's set is the greedy set
        g_bm, g_cnt = tmis.mis_greedy_update(
            torch.zeros_like(t_bm), torch.zeros(P, dtype=torch.int32),
            torch.as_tensor(emb), torch.as_tensor(nv), torch.as_tensor(tau), k)
        assert torch.equal(g_bm[0], t_bm[0]) and int(g_cnt[0]) == int(t_cnt[0])


def test_touches_used_equal():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
    verts = rng.integers(0, 256, (50, 3)).astype(np.int32)
    a = jmis.touches_used(jnp.asarray(words), jnp.asarray(verts))
    b = tmis.touches_used(interop.bitmap_from_uint32(words),
                          torch.as_tensor(verts))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bitmap_interop_roundtrip():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF], np.uint32)
    t = interop.bitmap_from_uint32(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(interop.bitmap_to_uint32(t), words)


def test_kernel_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        mis_greedy_update_kernel(torch.zeros((1, 1), dtype=torch.int32,
                                             device="meta"),
                                 torch.zeros(1, dtype=torch.int32, device="meta"),
                                 torch.zeros((1, 4, 2), dtype=torch.int32,
                                             device="meta"),
                                 torch.zeros(1, dtype=torch.int32, device="meta"),
                                 torch.zeros(1, dtype=torch.int32, device="meta"),
                                 2)
