"""Synthetic data: graphs for frequent-subgraph mining and the GNN cells,
and DLRM batches.

The paper's datasets are SNAP graphs with *randomly assigned* labels (§4).
Offline we synthesize structure-matched stand-ins: R-MAT graphs with the
same |V|, |E|, |V_l| and random labels — label selectivity and degree skew
(the two workload-shaping statistics) are faithful by construction.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np

from ..core.graph import DataGraph, build_graph, sorted_unique

__all__ = ["rmat_graph", "rmat_undirected_graph", "paper_dataset",
           "PAPER_DATASETS", "dlrm_batches"]

_RMAT_CHUNK = 1 << 20   # edges a thread draws at a time


def _rmat_bits(rng: np.random.Generator, m_gen: int, scale: int, a: float,
               b: float, c: float) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's R-MAT draws: for each level (the bit), ``m_gen``
    uniforms pick a quadrant per edge; c or d sets the source bit, b or d
    the destination bit.  The same draws, cut into chunks that threads fill
    at once: a PCG64 generator advanced to a chunk's first draw yields the
    draws the reference's sequential loop gives there (one 64-bit output
    per double).  ``rng`` ends advanced past all of them, as in the
    reference."""
    state = rng.bit_generator.state
    src = np.zeros(m_gen, dtype=np.int64)
    dst = np.zeros(m_gen, dtype=np.int64)

    def fill(lo: int) -> None:
        hi = min(lo + _RMAT_CHUNK, m_gen)
        s = np.zeros(hi - lo, dtype=np.int32)
        d = np.zeros(hi - lo, dtype=np.int32)
        for level in range(scale):
            bits = np.random.PCG64()
            bits.state = state
            bits.advance(level * m_gen + lo)
            r = np.random.Generator(bits).random(hi - lo)
            # quadrant = number of thresholds passed: 0 a, 1 b, 2 c, 3 d
            q = ((r >= a).view(np.int8) + (r >= a + b).view(np.int8)
                 + (r >= a + b + c).view(np.int8))
            s |= (q >= 2).astype(np.int32) << level
            d |= (q & 1).astype(np.int32) << level
        src[lo:hi], dst[lo:hi] = s, d

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(0, m_gen, _RMAT_CHUNK)))
    rng.bit_generator.advance(scale * m_gen)
    return src, dst


def rmat_graph(n: int, m: int, *, n_labels: int = 5, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               undirected: bool = False) -> DataGraph:
    """R-MAT (Chakrabarti et al.) directed labeled graph, power-law degrees."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n, 2)))))
    # oversample to survive self-loop/dup removal
    m_gen = int(m * 1.3) + 16
    src, dst = _rmat_bits(rng, m_gen, scale, a, b, c)
    keep = (src < n) & (dst < n) & (src != dst)
    src, dst = src[keep], dst[keep]
    keys = sorted_unique(src * n + dst)[:m]
    src, dst = keys // n, keys % n
    labels = rng.integers(0, n_labels, n).astype(np.int32)
    edges = np.stack([src, dst], axis=1)
    return build_graph(n, edges, labels, n_labels=n_labels,
                       undirected=undirected)


def rmat_undirected_graph(n: int, n_edges: int, *, seed: int = 0
                          ) -> DataGraph:
    """Undirected R-MAT graph with exactly ``n_edges`` directed edges:
    ``n_edges / 2`` distinct vertex pairs, each stored both ways, one label.

    The draws are `rmat_graph`'s, with its default quadrant probabilities.
    `rmat_graph` keeps the distinct draws of one oversampled round, which
    falls short of the count asked for once hub pairs repeat (96.2 M of
    Reddit's 114.6 M directed edges).  Here rounds of R-MAT draws go on
    until there are enough distinct pairs, each round sized by the share of
    new pairs the round before gave; the surplus of the last round is
    dropped at random."""
    if n_edges % 2:
        raise ValueError(f"an undirected graph has an even number of "
                         f"directed edges, not {n_edges}")
    want = n_edges // 2
    if want > n * (n - 1) // 2:
        raise ValueError(f"{n} vertices hold at most {n * (n - 1) // 2} pairs")
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n, 2)))))
    pairs = np.zeros(0, dtype=np.int64)
    share = 1.0 / 1.3   # new pairs per draw, as `rmat_graph` budgets
    for _ in range(8):
        if pairs.size >= want:
            break
        m_gen = min(int((want - pairs.size) / share * 1.1) + 16, 4 * want)
        src, dst = _rmat_bits(rng, m_gen, scale, 0.57, 0.19, 0.19)
        keep = (src < n) & (dst < n) & (src != dst)
        src, dst = src[keep], dst[keep]
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        before = pairs.size
        pairs = sorted_unique(np.concatenate([pairs, lo * n + hi]))
        share = max((pairs.size - before) / m_gen, 1e-3)
    if pairs.size < want:
        raise ValueError(f"R-MAT draws reach only {pairs.size} of {want} "
                         f"distinct pairs on {n} vertices")
    if pairs.size > want:
        drop = rng.choice(pairs.size, pairs.size - want, replace=False)
        pairs = np.delete(pairs, drop)
    edges = np.stack([pairs // n, pairs % n], axis=1)
    return build_graph(n, edges, np.zeros(n, dtype=np.int32), n_labels=1,
                       undirected=True)


# Paper Table 1, scaled stand-ins (scale=1.0 reproduces the table sizes).
PAPER_DATASETS: Dict[str, Dict] = {
    "gnutella": dict(n=6301, m=20777, n_labels=5),
    "epinions": dict(n=75879, m=508837, n_labels=5),
    "slashdot": dict(n=82168, m=948464, n_labels=5),
    "wiki-vote": dict(n=7115, m=103689, n_labels=5),
    "mico": dict(n=100000, m=1080298, n_labels=29),
}


def paper_dataset(name: str, *, scale: float = 1.0, seed: int = 0) -> DataGraph:
    cfg = PAPER_DATASETS[name]
    n = max(16, int(cfg["n"] * scale))
    m = max(32, int(cfg["m"] * scale))
    return rmat_graph(n, m, n_labels=cfg["n_labels"], seed=seed,
                      undirected=True)


def dlrm_batches(cfg, batch: int, *, seed: int = 0, start_step: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """The reference's DLRM batches, draw for draw: step-indexed numpy
    generators, dense normals, uniform sparse ids, binary labels."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        yield {
            "dense": rng.normal(size=(batch, cfg.n_dense)).astype(np.float32),
            "sparse_idx": rng.integers(
                0, cfg.table_rows, (batch, cfg.n_sparse, cfg.n_hot)
            ).astype(np.int32),
            "labels": rng.integers(0, 2, (batch,)).astype(np.int32),
        }
        step += 1
