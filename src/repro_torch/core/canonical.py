"""Canonical forms and automorphisms for tiny pattern graphs.

The paper uses the Bliss library. Our patterns are at most ~8 vertices, so an
exact, dependency-free, *vectorized* brute force over all k! permutations is
both simpler and fast enough (8! = 40320 — a single batched numpy pass).

The canonical key of a pattern is the lexicographically smallest
(labels, adjacency-bits) tuple over every relabeling that is consistent with
a label-preserving permutation.  Two patterns are isomorphic iff their keys
are equal.  The automorphism group is the set of permutations mapping a
pattern onto itself.

Permutation tables are cached per (k, label-multiset) — label-preserving
permutations only, which prunes k! hard for labeled patterns.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Tuple

import numpy as np

from .pattern import Pattern

__all__ = [
    "canonical_key",
    "canonical_form",
    "are_isomorphic",
    "automorphisms",
    "dedupe_patterns",
]

_MAX_K = 9


@functools.lru_cache(maxsize=None)
def _all_perms(k: int) -> np.ndarray:
    if k > _MAX_K:
        raise ValueError(f"pattern too large for brute-force canonicalization: k={k}")
    return np.array(list(itertools.permutations(range(k))), dtype=np.int64)


def _label_preserving_perms(labels: np.ndarray) -> np.ndarray:
    """All permutations p with labels[p] == labels (vectorized filter)."""
    k = labels.shape[0]
    perms = _all_perms(k)
    # perm p maps vertex i -> position p[i]; label preservation means
    # labels[i] == labels[p[i]] for all i  ⇔  labels[perms] == labels row-wise
    ok = np.all(labels[perms] == labels[None, :], axis=1)
    return perms[ok]


def _apply_perms(pat: Pattern, perms: np.ndarray) -> np.ndarray:
    """Batched pattern.permuted: returns (P, k, k) bool adjacency stack.

    For perm p, new_adj[p[i], p[j]] = adj[i, j]  ⇔  new_adj = adj[inv][:, inv]
    where inv is the inverse permutation.
    """
    k = pat.k
    P = perms.shape[0]
    inv = np.empty_like(perms)
    rows = np.arange(P)[:, None]
    inv[rows, perms] = np.arange(k)[None, :]
    # gather: out[p, a, b] = adj[inv[p, a], inv[p, b]]
    return pat.adj[inv[:, :, None], inv[:, None, :]]


def _bits(adj_stack: np.ndarray) -> np.ndarray:
    """Pack (P, k, k) bool into (P, ceil(k*k/8)) uint8 rows for lexsort."""
    P = adj_stack.shape[0]
    return np.packbits(adj_stack.reshape(P, -1), axis=1)


def canonical_key(pat: Pattern) -> Tuple:
    """Exact canonical key; equal keys ⇔ isomorphic patterns."""
    k = pat.k
    if k == 0:
        return (0, b"", b"")
    # Candidate orderings must sort labels canonically first: relabel by
    # sorted label order, then only label-preserving perms of that base.
    order = np.argsort(pat.labels, kind="stable")
    base = pat.permuted(np.argsort(order))  # vertex i -> rank of i in sorted order
    perms = _label_preserving_perms(base.labels)
    stack = _apply_perms(base, perms)
    bits = _bits(stack)
    # lexicographic min over rows
    best = min(range(bits.shape[0]), key=lambda i: bits[i].tobytes())
    return (k, base.labels.tobytes(), bits[best].tobytes())


def canonical_form(pat: Pattern) -> Pattern:
    """A concrete representative pattern of the canonical key."""
    k = pat.k
    if k == 0:
        return pat
    order = np.argsort(pat.labels, kind="stable")
    base = pat.permuted(np.argsort(order))
    perms = _label_preserving_perms(base.labels)
    stack = _apply_perms(base, perms)
    bits = _bits(stack)
    best = min(range(bits.shape[0]), key=lambda i: bits[i].tobytes())
    return Pattern(stack[best], base.labels)


def are_isomorphic(a: Pattern, b: Pattern) -> bool:
    if a.k != b.k or sorted(a.labels.tolist()) != sorted(b.labels.tolist()):
        return False
    return canonical_key(a) == canonical_key(b)


def automorphisms(pat: Pattern) -> np.ndarray:
    """All permutations mapping the pattern onto itself, (A, k) int64.

    Row 0 is always the identity.
    """
    k = pat.k
    if k == 0:
        return np.zeros((1, 0), dtype=np.int64)
    perms = _label_preserving_perms(pat.labels)
    stack = _apply_perms(pat, perms)
    ok = np.all(stack == pat.adj[None], axis=(1, 2))
    auts = perms[ok]
    # put identity first
    ident = np.all(auts == np.arange(k)[None, :], axis=1)
    order = np.argsort(~ident, kind="stable")
    return auts[order]


def find_isomorphism(a: Pattern, b: Pattern) -> np.ndarray | None:
    """A permutation p with a.permuted(p) == b, or None."""
    if a.k != b.k or sorted(a.labels.tolist()) != sorted(b.labels.tolist()):
        return None
    perms = _all_perms(a.k)
    # need labels_a[i] == labels_b[p[i]]: filter
    ok = np.all(a.labels[None, :] == b.labels[perms], axis=1)
    perms = perms[ok]
    if perms.shape[0] == 0:
        return None
    stack = _apply_perms(a, perms)
    hit = np.all(stack == b.adj[None], axis=(1, 2))
    idx = np.nonzero(hit)[0]
    return perms[idx[0]] if idx.size else None


def dedupe_patterns(patterns: List[Pattern]) -> List[Pattern]:
    """RemoveDuplicates (Alg 2, line 11): keep one pattern per canonical key."""
    seen = {}
    for p in patterns:
        key = canonical_key(p)
        if key not in seen:
            seen[key] = p
    return list(seen.values())
