"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
where ``torch.cuda.is_available()`` is false.  On the card run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`` (the
shared conftest imports JAX, which the card's machine does not have; this
file needs neither JAX nor ``repro``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import MatchConfig, MiningConfig, build_graph, mine
from repro_torch.core.mis import bitmap_words
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels.frontier_expand.kernel import frontier_expand
from repro_torch.kernels.mis_bitmap.kernel import (
    mis_bitmap_select, uses_shared_memory,
)
from repro_torch.testing.parity import (
    frontier_case, mis_case, patterns_by_k, random_graph,
)

pytestmark = pytest.mark.gpu

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cfg(g, cap=256, root_block=128, chunk=64):
    return dataclasses.replace(
        MatchConfig.for_graph(g, cap=cap, root_block=root_block, chunk=chunk),
        two_phase=False)


@pytest.mark.parametrize("undirected", [True, False])
def test_frontier_levels_k2_to_k5(cuda, undirected):
    g = random_graph(300, 3, 3, seed=1, undirected=undirected)
    cfg = _cfg(g)
    by_k = patterns_by_k(g, 5)
    assert max(by_k) == 5
    for k, pats in by_k.items():
        for bs in (0, cfg.root_block):
            assert frontier_case(g, pats, cfg, cuda, block_start=bs) == 0


def test_frontier_stacked_bucket_multi_chunk(cuda):
    # chunk 4 < max degree: several chunks, so order is chunk-major
    g = random_graph(200, 4, 2, seed=3)
    cfg = _cfg(g, cap=512, chunk=4)
    assert cfg.max_chunks > 1
    for k, pats in patterns_by_k(g, 4, per_level=8).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


@pytest.mark.parametrize("cap", [1000, 16384])
def test_frontier_skewed_degrees(cuda, cap):
    # R-MAT hubs: rows with many chunks beside rows with one; cap 1000 ends
    # inside a row tile, 16384 spans many tiles
    g = rmat_graph(3000, 30000, n_labels=2, seed=4)
    cfg = _cfg(g, cap=cap, root_block=1024, chunk=16)
    assert cfg.max_chunks > 4
    for k, pats in patterns_by_k(g, 3, per_level=8).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


def test_frontier_chunk_above_64_raises(cuda):
    g = random_graph(100, 3, 2, seed=2)
    cfg = _cfg(g, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        frontier_case(g, patterns_by_k(g, 2)[2],
                      dataclasses.replace(cfg, chunk=128), cuda)


def test_frontier_overflow(cuda):
    g = random_graph(200, 6, 1, seed=5)
    cfg = _cfg(g, cap=64, root_block=128)
    for k, pats in patterns_by_k(g, 3).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


def test_frontier_edgeless(cuda):
    n = 32
    g = build_graph(n, np.zeros((0, 2), np.int64), np.zeros(n, np.int32))
    from repro_torch.core import Pattern
    pat = Pattern(np.array([[False, True], [False, False]]),
                  np.zeros(2, np.int32))
    assert frontier_case(g, [pat], _cfg(g, cap=64, root_block=32), cuda) == 0


def test_mis_tau_cut_and_carry(cuda):
    # P = 4: one τ cut mid-table, one never reached, two in between
    assert mis_case(5000, 4, 1024, 3, 3, seed=7, device=cuda,
                    taus=[50, INT32_MAX, 200, 1], calls=2) == 0


def test_mis_global_bitmap_large_graph(cuda):
    # above the shared-memory limit: the global-memory branch, with a τ cut
    n = 2_000_000
    assert not uses_shared_memory(bitmap_words(n), cuda)
    assert mis_case(n, 3, 4096, 5, 4, seed=11, device=cuda,
                    taus=[INT32_MAX, 300, 1], calls=2) == 0


def test_mis_shared_bitmap_above_48k(cuda):
    n = 1_000_000   # 125 KB of words: the opt-in shared-memory branch
    assert uses_shared_memory(bitmap_words(n), cuda)
    assert mis_case(n, 3, 4096, 3, 3, seed=13, device=cuda,
                    taus=[INT32_MAX, 100, 2000], calls=2) == 0


@pytest.mark.parametrize("metric", ["mis", "mis_luby", "mni", "frac"])
def test_mine_cuda_equals_cpu(cuda, metric):
    g = random_graph(400, 3, 3, seed=17)
    match = MatchConfig.for_graph(g, cap=2048, root_block=128, chunk=8)
    res = {}
    for dev in ("cpu", "cuda"):
        cfg = MiningConfig(sigma=6, metric=metric, max_pattern_size=4,
                           execution="batched", match=match)
        r = mine(g, cfg, device=dev)
        res[dev] = ([(p.key(), s) for p, s in r.frequent],
                    [(s.support, s.embeddings_found, s.blocks_run,
                      s.overflowed) for s in r.stats])
    assert res["cpu"] == res["cuda"]


@pytest.mark.parametrize("execution", ["batched", "sequential"])
def test_mine_defaults_launch_both_kernels(cuda, execution):
    # the Python API with default settings (device "cuda", default
    # MatchConfig) must reach both kernels, not the plain versions
    g = random_graph(400, 3, 3, seed=19)
    frontier_expand.launches = 0
    mis_bitmap_select.launches = 0
    r = mine(g, MiningConfig(sigma=6, max_pattern_size=3,
                             execution=execution))
    assert r.frequent
    assert frontier_expand.launches > 0
    assert mis_bitmap_select.launches > 0
