"""Support metrics: MNI, Fractional-score, exact MIS, plus host oracles.

The device-side updates consume the matcher's embedding blocks with a
leading pattern axis P — (P, k, n) image/count tables — with per-pattern
results identical to P independent updates.  They have no kernel of their
own: plain torch scatter ops are their port.  Updates write into the table
they are given (in place, to keep one (P, k, n) table per bucket) and return
it.  The exact MIS (NP-hard, gold standard) runs on the host over the
materialized conflict graph and is used by tests only — precisely how the
paper treats it (§2.4: accurate but too expensive for production).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .graph import DataGraph
from .pattern import Pattern

__all__ = [
    "mni_init",
    "mni_update",
    "mni_value",
    "frac_init",
    "frac_update",
    "frac_value",
    "exact_mis",
    "greedy_mis_host",
    "enumerate_embeddings_host",
]


def _valid_entries(emb: torch.Tensor, n_valid: torch.Tensor, k: int):
    """(pattern, column, vertex) index triples of every valid row's first
    k columns (−1 clipped to 0), for a scatter into a (P, k, n) table."""
    P, cap = emb.shape[:2]
    valid = torch.arange(cap, device=emb.device)[None] < n_valid[:, None]
    p_idx, r_idx = valid.nonzero(as_tuple=True)
    vs = emb[p_idx, r_idx, :k].clamp(min=0).long()            # (m, k)
    cols = torch.arange(k, device=emb.device)[None].expand_as(vs)
    return p_idx[:, None].expand_as(vs), cols, vs


# ---------------------------------------------------------------------------
# MNI (GraMi / T-FSM-MNI): per-pattern-vertex distinct image counts, min.
# ---------------------------------------------------------------------------

def mni_init(k: int, n: int, device="cpu") -> torch.Tensor:
    """(k, n) bool image table — images[v, d] ⇔ some embedding maps v → d."""
    return torch.zeros((k, n), dtype=torch.bool, device=device)


def mni_update(images: torch.Tensor, emb: torch.Tensor, n_valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """images (P, k, n) bool; emb (P, cap, K) int32; n_valid (P,) int32."""
    images[_valid_entries(emb, n_valid, k)] = True
    return images


def mni_value(images: torch.Tensor) -> torch.Tensor:
    """(P,) int32 — min over pattern vertices of the distinct-image count."""
    return images.sum(-1).min(-1).values.to(torch.int32)


# ---------------------------------------------------------------------------
# Fractional-score (T-FSM): down-weight contested data vertices.
#
# count c[v, d] = #embeddings mapping pattern vertex v to data vertex d; a
# data vertex d's total load t[d] = Σ_v c[v, d]; the fractional image mass
# of v is Σ_d c[v, d] / t[d].  Support = min_v mass(v).
# ---------------------------------------------------------------------------

def frac_init(k: int, n: int, device="cpu") -> torch.Tensor:
    return torch.zeros((k, n), dtype=torch.float32, device=device)


def frac_update(counts: torch.Tensor, emb: torch.Tensor, n_valid: torch.Tensor,
                k: int) -> torch.Tensor:
    """counts (P, k, n) float32; sums of 1.0, exact below 2**24."""
    idx = _valid_entries(emb, n_valid, k)
    counts.index_put_(idx, torch.ones(idx[0].shape, dtype=torch.float32,
                                      device=counts.device), accumulate=True)
    return counts


def frac_value(counts: torch.Tensor) -> torch.Tensor:
    """(P,) float32 fractional mass (the reference's formula; the float32
    reduction order may move the last bit)."""
    total = counts.sum(-2, keepdim=True)                       # (P, 1, n)
    share = torch.where(total > 0, counts / total.clamp(min=1.0),
                        torch.zeros_like(counts))
    return share.sum(-1).min(-1).values


# ---------------------------------------------------------------------------
# Exact MIS over the embedding conflict graph (host, branch & bound).
# ---------------------------------------------------------------------------

def _conflict_adj(embs: np.ndarray) -> List[int]:
    """Bitmask adjacency of the conflict graph (embeddings sharing a vertex)."""
    m = embs.shape[0]
    adj = [0] * m
    sets = [frozenset(row.tolist()) for row in embs]
    for i in range(m):
        for j in range(i + 1, m):
            if sets[i] & sets[j]:
                adj[i] |= 1 << j
                adj[j] |= 1 << i
    return adj


def exact_mis(embs: np.ndarray, limit: int = 10**7) -> int:
    """Maximum independent set size of the embedding conflict graph.

    Branch and bound with greedy lower bound + remaining-count upper bound.
    `limit` caps explored nodes (raises if exceeded — tests use small sets).
    """
    embs = np.asarray(embs)
    m = embs.shape[0]
    if m == 0:
        return 0
    if m > 60:
        # group identical-vertex-set duplicates first
        uniq = {tuple(sorted(r.tolist())) for r in embs}
        embs = np.array(sorted(uniq))
        m = embs.shape[0]
        if m > 60:
            raise ValueError(f"exact MIS limited to 60 embeddings, got {m}")
    adj = _conflict_adj(embs)
    full = (1 << m) - 1
    best = 0
    nodes = 0

    def bb(avail: int, size: int):
        nonlocal best, nodes
        nodes += 1
        if nodes > limit:
            raise RuntimeError("exact_mis node limit exceeded")
        if size + bin(avail).count("1") <= best:
            return
        if avail == 0:
            best = max(best, size)
            return
        v = (avail & -avail).bit_length() - 1  # lowest set bit
        # branch 1: take v
        bb(avail & ~adj[v] & ~(1 << v), size + 1)
        # branch 2: skip v
        bb(avail & ~(1 << v), size)

    bb(full, 0)
    return best


def greedy_mis_host(embs: np.ndarray) -> List[int]:
    """Lexicographically-first maximal independent set (host oracle)."""
    used: set = set()
    picked = []
    for i, row in enumerate(np.asarray(embs)):
        vs = set(int(v) for v in row)
        if not (vs & used):
            used |= vs
            picked.append(i)
    return picked


# ---------------------------------------------------------------------------
# Brute-force embedding enumeration (host oracle for matcher tests).
# ---------------------------------------------------------------------------

def enumerate_embeddings_host(g: DataGraph, pat: Pattern, cap: int = 10**6) -> np.ndarray:
    """All injective label/edge-preserving mappings pattern → data graph.

    Subgraph-isomorphism semantics per the paper §2.1.4: pattern edges must
    exist in the data graph; extra data-graph edges between images are fine.
    Returns (M, k) int32 rows ordered lexicographically by image tuple.
    """
    k = pat.k
    cands = [np.nonzero(g.labels == pat.labels[v])[0] for v in range(k)]
    out: List[Tuple[int, ...]] = []

    def extend(partial: List[int]):
        i = len(partial)
        if i == k:
            out.append(tuple(partial))
            return
        for d in cands[i]:
            d = int(d)
            if d in partial:
                continue
            ok = True
            for j in range(i):
                if pat.adj[j, i] and not g.has_edge(partial[j], d):
                    ok = False
                    break
                if pat.adj[i, j] and not g.has_edge(d, partial[j]):
                    ok = False
                    break
            if ok:
                extend(partial + [d])
                if len(out) >= cap:
                    raise RuntimeError("embedding cap exceeded")

    extend([])
    return np.array(out, dtype=np.int32).reshape(-1, k)
