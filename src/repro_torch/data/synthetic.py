"""Synthetic data graphs for frequent-subgraph mining.

The paper's datasets are SNAP graphs with *randomly assigned* labels (§4).
Offline we synthesize structure-matched stand-ins: R-MAT graphs with the
same |V|, |E|, |V_l| and random labels — label selectivity and degree skew
(the two workload-shaping statistics) are faithful by construction.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.graph import DataGraph, build_graph

__all__ = ["rmat_graph", "paper_dataset", "PAPER_DATASETS"]


def rmat_graph(n: int, m: int, *, n_labels: int = 5, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               undirected: bool = False) -> DataGraph:
    """R-MAT (Chakrabarti et al.) directed labeled graph, power-law degrees."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n, 2)))))
    n_pow = 1 << scale
    # oversample to survive self-loop/dup removal
    m_gen = int(m * 1.3) + 16
    src = np.zeros(m_gen, dtype=np.int64)
    dst = np.zeros(m_gen, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m_gen)
        quad_b = (r >= a) & (r < a + b)
        quad_c = (r >= a + b) & (r < a + b + c)
        quad_d = r >= a + b + c
        bit = 1 << level
        src += bit * (quad_c | quad_d)
        dst += bit * (quad_b | quad_d)
    keep = (src < n) & (dst < n) & (src != dst)
    src, dst = src[keep], dst[keep]
    keys = np.unique(src * n + dst)[:m]
    src, dst = keys // n, keys % n
    labels = rng.integers(0, n_labels, n).astype(np.int32)
    edges = np.stack([src, dst], axis=1)
    return build_graph(n, edges, labels, n_labels=n_labels,
                       undirected=undirected)


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
