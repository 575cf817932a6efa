"""Host logic of the redesigned backward kernels, on the CPU.

The bf16 flash backward at hd 64 / 128 (``csrc/flash_attention_bwd.cu``)
computes its work ranges, step order and dQ ranks in closed form;
``kernels/flash_attention/schedule.py`` states the same forms, and here
they are held to a brute-force enumeration of the forward's liveness test
over causal, windowed, non-causal and ragged S, and the ordered dQ adds
are played out (`schedule.simulate`) to show they end in ascending key
order with few or many resident CTAs.  Also: the wrapper's dispatch and
workspace shapes, the build's hash over included headers, the aggregate
transpose's path choice and the out-neighbour CSR of its hub case.
No JAX here: these are the port's own host functions.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import schedule as sc
from repro_torch.kernels.gather_aggregate.kernel import aggt_mode
from repro_torch.kernels.gather_aggregate.ops import out_neighbor_csr
from repro_torch.testing.parity import AGG_T_HUB, agg_t_hub_inputs

LENGTHS = (1, 63, 64, 65, 127, 128, 129, 1000, 1100, 4096)
MASKS = [(True, None), (False, None), (True, 1), (True, 16), (True, 100),
         (True, 512), (True, 5000), (False, 60)]


def _brute_live(S, causal, window):
    nq, nk = sc.n_tiles(S)
    return {(qi, kt) for qi in range(nq) for kt in range(nk)
            if sc.live(qi, kt, causal, window)}


def _pair_live(qi, kt, S, causal, window):
    """Some (query, key) pair of the tiles inside S is unmasked."""
    for q in range(qi * sc.TQ, min(S, (qi + 1) * sc.TQ)):
        for k in range(kt * sc.TK, min(S, (kt + 1) * sc.TK)):
            if (not causal or k <= q) and (window is None or q - k < window):
                return True
    return False


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("causal,window", MASKS)
def test_ranges_match_brute_force(S, causal, window):
    nq, nk = sc.n_tiles(S)
    live = _brute_live(S, causal, window)
    for kt in range(nk):
        want = sorted(qi for qi in range(nq) if (qi, kt) in live)
        lo, hi = sc.q_range(kt, S, causal, window)
        assert want == list(range(lo, hi + 1)), (kt, want, lo, hi)
    for qi in range(nq):
        want = sorted(kt for kt in range(nk) if (qi, kt) in live)
        lo, hi = sc.k_range(qi, S, causal, window)
        assert want == list(range(lo, hi + 1)), (qi, want, lo, hi)
        for rank, kt in enumerate(want):
            assert sc.dq_rank(qi, kt, S, causal, window) == (
                rank, kt == want[-1])


@pytest.mark.parametrize("S", (1, 65, 129, 300))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (False, 60)])
def test_every_attending_pair_is_covered(S, causal, window):
    """The tile test never drops a pair the mask keeps (it may keep tiles
    whose pairs the masks then zero)."""
    nq, nk = sc.n_tiles(S)
    live = _brute_live(S, causal, window)
    for qi, kt in itertools.product(range(nq), range(nk)):
        if _pair_live(qi, kt, S, causal, window):
            assert (qi, kt) in live, (qi, kt)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("G", (1, 2, 4))
def test_steps_visit_each_live_pair_once_last_tile_first(S, causal, window,
                                                         G):
    nq, nk = sc.n_tiles(S)
    live = _brute_live(S, causal, window)
    for kt in range(nk):
        got = sc.steps(kt, S, G, causal, window)
        want = {(qi, g) for qi in range(nq) if (qi, kt) in live
                for g in range(G)}
        assert len(got) == len(want) and set(got) == want
        # query tiles descend, heads inner: the items that feed a query
        # tile reach it at the same step index
        assert got == sorted(got, key=lambda p: (-p[0], p[1]))


@pytest.mark.parametrize("BKV", (1, 3, 8))
@pytest.mark.parametrize("S", (1, 129, 1024, 4096))
def test_tickets_are_key_tile_major(BKV, S):
    _, nk = sc.n_tiles(S)
    items = [sc.item(t, BKV) for t in range(BKV * nk)]
    assert sorted(items) == sorted(itertools.product(range(BKV), range(nk)))
    assert [kt for _, kt in items] == sorted(kt for _, kt in items)


@pytest.mark.parametrize("S,causal,window,G,BKV,resident", [
    (1024, True, None, 2, 4, 1),
    (1024, True, None, 2, 4, 7),
    (4096, True, None, 2, 8, 132),
    (1100, True, 100, 4, 3, 5),
    (1000, False, None, 2, 2, 3),
    (777, False, 60, 1, 5, 2),
    (129, True, None, 2, 2, 1),
    (1, True, None, 2, 2, 1),
])
def test_ordered_dq_adds_end_in_ascending_key_order(S, causal, window, G,
                                                    BKV, resident):
    order = sc.simulate(BKV, G, S, causal, window, resident)
    nq, _ = sc.n_tiles(S)
    assert set(order) == {(bh, qi) for bh in range(BKV * G)
                          for qi in range(nq)}
    for (bh, qi), kts in order.items():
        lo, hi = sc.k_range(qi, S, causal, window)
        assert kts == list(range(lo, hi + 1)), (bh, qi, kts)


@pytest.mark.parametrize("is_bf16,hd,path", [
    (True, 128, "wgmma"), (True, 64, "wgmma"), (True, 32, "mma"),
    (True, 16, "mma"), (False, 128, "f32"), (False, 16, "f32")])
def test_bwd_path_and_workspace(is_bf16, hd, path):
    assert sc.bwd_path(is_bf16, hd) == path
    work = sc.bwd_workspace(64, 1000, hd, path)
    if path == "wgmma":
        nq = -(-1000 // 64)
        assert work == {"dvec": (2, 64, nq * 64),
                        "dq_acc": (64, nq * 64, hd),
                        "sync": (1 + 64 * nq * 2,)}
    else:
        assert work == {"dvec": (64, 1000)}


def test_build_hash_follows_included_headers(tmp_path, monkeypatch):
    src, hdr, inner = (tmp_path / "k.cu", tmp_path / "a.cuh",
                       tmp_path / "b.cuh")
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    hdr.write_text('#pragma once\n#include "b.cuh"\n')
    inner.write_text("// v1\n")
    monkeypatch.setitem(_build.SOURCES, "probe", src)
    assert _build.included_headers(src) == [hdr, inner]
    first = _build.library_path("probe")
    inner.write_text("// v2\n")
    assert _build.library_path("probe") != first
    assert (_build.included_headers(_build.SOURCES["flash_attention_bwd"])
            == [_build.CSRC / "sm90.cuh"])


@pytest.mark.parametrize("F,esize,ptr,mode", [
    (128, 2, 0, 16), (128, 4, 256, 16), (8, 2, 16, 16), (128, 2, 2, 1),
    (128, 2, 4, 2), (128, 4, 4, 1), (128, 4, 8, 2), (602, 2, 0, 2),
    (7, 4, 0, 1), (6, 4, 16, 2), (12, 4, 16, 16)])
def test_aggt_mode(F, esize, ptr, mode):
    assert aggt_mode(F, esize, ptr) == mode


def test_out_neighbor_csr_of_a_hub():
    """The hub case's CSR (`parity.agg_t_hub_inputs`): node 7 holds 5 000
    destinations in ascending (i, j) order, most nodes none."""
    feats, nbrs = agg_t_hub_inputs(6000, 8, 3, torch.float32, "cpu")
    indptr, dst, deg = out_neighbor_csr(nbrs)
    counts = (indptr[1:] - indptr[:-1]).numpy()
    assert counts[7] >= AGG_T_HUB and counts.argmax() == 7
    assert (counts == 0).mean() > 0.5
    nb = nbrs.numpy()
    for u in (7, int(np.flatnonzero(counts == 1)[0])):
        rows = [i for i in range(nb.shape[0]) for j in range(nb.shape[1])
                if nb[i, j] == u]
        assert dst[indptr[u]:indptr[u + 1]].tolist() == rows
    np.testing.assert_array_equal(deg.numpy(), (nb >= 0).sum(1))
