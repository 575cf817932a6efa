"""The port's MNI and fractional-score updates against the JAX reference.

MNI image tables and values are exact.  Fractional count tables are sums
of 1.0 and exact too; ``frac_value`` divides and sums in float32, where the
reduction order may move the last bits, so it is held to rtol 1e-6 (the
frequent sets, which floor it, are compared exactly in test_torch_mine.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmet

from repro_torch import interop
from repro_torch.core import metrics as tmet

FRAC_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _tables(seed, P, n, cap, K, k):
    rng = np.random.default_rng(seed)
    emb = np.full((P, cap, K), -1, np.int32)
    nv = rng.integers(0, cap + 1, P).astype(np.int32)
    for p in range(P):
        for r in range(nv[p]):
            emb[p, r, :k] = rng.choice(n, k, replace=False)
    return emb, nv


@pytest.mark.parametrize("seed,P,n,k", [(0, 1, 50, 2), (1, 3, 80, 3),
                                        (2, 2, 33, 4)])
def test_mni_equal(seed, P, n, k):
    cap = 64
    t_tab = torch.zeros((P, k, n), dtype=torch.bool)
    j_tabs = [jmet.mni_init(k, n) for _ in range(P)]
    for call in range(2):
        emb, nv = _tables(seed * 7 + call, P, n, cap, k + 1, k)
        t_tab = tmet.mni_update(t_tab, torch.as_tensor(emb),
                                torch.as_tensor(nv), k)
        j_tabs = [jmet.mni_update(j_tabs[p], jnp.asarray(emb[p]),
                                  jnp.int32(nv[p]), k) for p in range(P)]
        vals = tmet.mni_value(t_tab)
        for p in range(P):
            np.testing.assert_array_equal(np.asarray(j_tabs[p]),
                                          interop.table_to_numpy(t_tab[p]))
            assert int(jmet.mni_value(j_tabs[p])) == int(vals[p])


@pytest.mark.parametrize("seed,P,n,k", [(0, 1, 40, 2), (1, 3, 60, 3),
                                        (3, 2, 25, 3)])
def test_frac_equal(seed, P, n, k):
    cap = 96
    t_tab = interop.table_from_numpy(np.zeros((P, k, n), np.float32))
    j_tabs = [jmet.frac_init(k, n) for _ in range(P)]
    for call in range(2):
        emb, nv = _tables(seed * 7 + call, P, n, cap, k, k)
        t_tab = tmet.frac_update(t_tab, torch.as_tensor(emb),
                                 torch.as_tensor(nv), k)
        j_tabs = [jmet.frac_update(j_tabs[p], jnp.asarray(emb[p]),
                                   jnp.int32(nv[p]), k) for p in range(P)]
        vals = tmet.frac_value(t_tab)
        for p in range(P):
            np.testing.assert_array_equal(np.asarray(j_tabs[p]),
                                          interop.table_to_numpy(t_tab[p]))
            np.testing.assert_allclose(float(vals[p]),
                                       float(jmet.frac_value(j_tabs[p])),
                                       rtol=FRAC_RTOL)


def test_host_oracles_equal():
    rng = np.random.default_rng(4)
    embs = np.stack([rng.choice(30, 3, replace=False) for _ in range(25)])
    assert tmet.greedy_mis_host(embs) == jmet.greedy_mis_host(embs)
    assert tmet.exact_mis(embs) == jmet.exact_mis(embs)
