"""Candidate-pattern generation (paper Algorithms 2–4).

FLEXIS generation: merge pairs of frequent (k−1)-vertex patterns sharing an
isomorphic (k−2)-vertex core graph Γ, under every automorphism of Γ; cliques
additionally require a third supporting pattern (Lemma 3.5), which we enforce
through the paper's own post-processing rule — *every connected (k−1)-vertex
subpattern of a candidate clique must be frequent* — the two are equivalent
(the third core graph exists iff the corresponding (k−1)-subclique is
frequent, see Lemma 3.5's proof).

The edge-extension baseline (GraMi/T-FSM-style growth) lives here too so the
benchmark harness can compare searched-pattern counts (paper Table 2).

Everything in this module is host-side numpy: pattern sets are small (control
plane).  The device plane is `matcher.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .pattern import Pattern
from .canonical import (
    automorphisms,
    canonical_key,
    dedupe_patterns,
    find_isomorphism,
)

__all__ = [
    "CoreGraph",
    "core_graphs",
    "core_groups",
    "generate_new_patterns",
    "edge_extension_candidates",
    "size2_patterns",
]


@dataclasses.dataclass(frozen=True)
class CoreGraph:
    """A pattern with one vertex disconnected (the *marked* vertex).

    gamma:       the (k−2)-vertex remainder Γ (marked vertex removed).
    attach_out:  (k−2,) bool — marked → Γ[i] edges.
    attach_in:   (k−2,) bool — Γ[i] → marked edges.
    marked_label: label of the marked vertex.
    parent:      the pattern this core graph came from.
    is_clique_parent: parent pattern is a clique (undirected sense).
    """

    gamma: Pattern
    attach_out: np.ndarray
    attach_in: np.ndarray
    marked_label: int
    parent: Pattern
    is_clique_parent: bool

    def remapped(self, perm: np.ndarray) -> "CoreGraph":
        """Express the attachment w.r.t. gamma.permuted(perm).

        perm maps our Γ vertex i to position perm[i] in the target Γ, so the
        target's attach vectors gather through the inverse.
        """
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        return CoreGraph(
            gamma=self.gamma.permuted(perm),
            attach_out=self.attach_out[inv],
            attach_in=self.attach_in[inv],
            marked_label=self.marked_label,
            parent=self.parent,
            is_clique_parent=self.is_clique_parent,
        )


def core_graphs(pat: Pattern) -> List[CoreGraph]:
    """All k core graphs of `pat` (one per marked vertex).

    Γ may be *disconnected* — and must be kept: Lemma 3.4 reconstructs e.g. a
    4-cycle from two 3-paths whose shared Γ is a pair of isolated vertices
    (the two non-adjacent cycle vertices removed).  Disconnected *candidates*
    are filtered after the merge instead.
    """
    out: List[CoreGraph] = []
    is_clq = pat.is_clique()
    for v in range(pat.k):
        gamma = pat.remove_vertex(v)
        keep = [i for i in range(pat.k) if i != v]
        out.append(
            CoreGraph(
                gamma=gamma,
                attach_out=pat.adj[v, keep].copy(),
                attach_in=pat.adj[keep, v].copy(),
                marked_label=int(pat.labels[v]),
                parent=pat,
                is_clique_parent=is_clq,
            )
        )
    return out


def core_groups(patterns: Sequence[Pattern]) -> Dict[Tuple, List[CoreGraph]]:
    """Group core graphs by canonical key of Γ, remapping each onto the
    group representative's Γ so attachments are directly comparable."""
    groups: Dict[Tuple, List[CoreGraph]] = {}
    reps: Dict[Tuple, Pattern] = {}
    for pat in patterns:
        for cg in core_graphs(pat):
            key = canonical_key(cg.gamma)
            if key not in groups:
                groups[key] = [cg]
                reps[key] = cg.gamma
            else:
                perm = find_isomorphism(cg.gamma, reps[key])
                assert perm is not None, "canonical key collision"
                groups[key].append(cg.remapped(perm))
    return groups


def _merge(c1: CoreGraph, c2: CoreGraph, alpha: np.ndarray) -> Pattern:
    """MERGE (Alg 2 line 8): Γ + marked(C1) + α-twisted marked(C2).

    Both core graphs must already be expressed w.r.t. the same Γ. α is an
    automorphism of Γ applied to C2's attachment.
    """
    g = c1.gamma
    m = g.k
    adj = np.zeros((m + 2, m + 2), dtype=bool)
    adj[:m, :m] = g.adj
    # vertex m   = marked of c1
    adj[m, :m] = c1.attach_out
    adj[:m, m] = c1.attach_in
    # vertex m+1 = marked of c2, attachment twisted by α:
    # α maps Γ vertex i -> α[i]; c2's marked connected to i now connects to α[i]
    a_out = np.zeros(m, dtype=bool)
    a_in = np.zeros(m, dtype=bool)
    a_out[alpha] = c2.attach_out
    a_in[alpha] = c2.attach_in
    adj[m + 1, :m] = a_out
    adj[:m, m + 1] = a_in
    labels = np.concatenate([g.labels, [c1.marked_label, c2.marked_label]])
    return Pattern(adj, labels.astype(np.int32))


def _connected_subpatterns(pat: Pattern) -> List[Pattern]:
    subs = []
    for v in range(pat.k):
        sp = pat.remove_vertex(v)
        if sp.is_connected():
            subs.append(sp)
    return subs


def _clique_completions(
    merged: Pattern, frequent_keys: set
) -> List[Pattern]:
    """GENERATECLIQUES (Alg 4) via the paper's post-processing rule.

    `merged` is a k-pattern whose last two vertices (the two marked vertices)
    are not joined.  If every other pair is joined, adding a directed edge
    between them can complete a clique.  We enumerate the three directed
    closures and keep those whose connected (k−1)-subpatterns are *all*
    frequent — the paper's final check, equivalent to finding the third
    supporting core graph (Lemma 3.5).
    """
    k = pat_k = merged.k
    u, v = pat_k - 2, pat_k - 1
    und = merged.undirected_adj()
    # all pairs except (u, v) must already be joined
    need = ~(und | np.eye(k, dtype=bool))
    need[u, v] = need[v, u] = False
    if np.any(need):
        return []
    out = []
    for e_uv, e_vu in ((True, False), (False, True), (True, True)):
        adj = merged.adj.copy()
        adj[u, v] = e_uv
        adj[v, u] = e_vu
        cand = Pattern(adj, merged.labels)
        if all(canonical_key(sp) in frequent_keys for sp in _connected_subpatterns(cand)):
            out.append(cand)
    return out


def generate_new_patterns(
    frequent: Sequence[Pattern],
    *,
    downward_closure: bool = True,
) -> List[Pattern]:
    """GENERATENEWPATTERNS (Algorithm 2): all k-vertex candidates from the
    frequent (k−1)-vertex set.

    downward_closure: additionally require every connected (k−1)-subpattern
    of a *non-clique* candidate to be frequent.  The paper proves this prunes
    no frequent pattern (Theorem 3.6's anti-monotone argument); it is always
    applied to cliques (part of Alg 4) and we default it on everywhere.
    """
    if not frequent:
        return []
    frequent_keys = {canonical_key(p) for p in frequent}
    groups = core_groups(frequent)
    out: List[Pattern] = []
    for key, cgs in groups.items():
        if not cgs:
            continue
        auts = automorphisms(cgs[0].gamma)
        for i in range(len(cgs)):
            for j in range(i, len(cgs)):
                c1, c2 = cgs[i], cgs[j]
                # dedupe attachment twists: distinct α images only
                seen_twists = set()
                for alpha in auts:
                    tw = (c2.attach_out[np.argsort(alpha)].tobytes(),
                          c2.attach_in[np.argsort(alpha)].tobytes())
                    if tw in seen_twists:
                        continue
                    seen_twists.add(tw)
                    cand = _merge(c1, c2, alpha)
                    if not cand.is_connected():
                        continue
                    out.append(cand)
                    if c1.is_clique_parent and c2.is_clique_parent:
                        out.extend(_clique_completions(cand, frequent_keys))
    out = dedupe_patterns(out)
    if downward_closure:
        out = [
            p
            for p in out
            if all(canonical_key(sp) in frequent_keys for sp in _connected_subpatterns(p))
        ]
    return out


# ---------------------------------------------------------------------------
# Baseline: edge-extension generation (GraMi / T-FSM growth rule)
# ---------------------------------------------------------------------------

def size2_patterns(labels: Iterable[int]) -> List[Pattern]:
    """All directed 2-vertex candidates over a label set: ℓ1→ℓ2 and ℓ1⇄ℓ2."""
    labs = sorted(set(int(l) for l in labels))
    out: List[Pattern] = []
    for a in labs:
        for b in labs:
            adj = np.zeros((2, 2), dtype=bool)
            adj[0, 1] = True
            out.append(Pattern(adj.copy(), np.array([a, b], np.int32)))
            adj[1, 0] = True
            out.append(Pattern(adj, np.array([a, b], np.int32)))
    return dedupe_patterns(out)


def edge_extension_candidates(
    frequent: Sequence[Pattern],
    vertex_labels: Sequence[int],
    *,
    max_k: int | None = None,
) -> List[Pattern]:
    """Grow each frequent pattern by exactly one edge (GraMi-style).

    Two growth moves: (a) attach a brand-new vertex (any label, either
    direction) to any existing vertex; (b) close an edge between an existing
    non-adjacent (directed) pair.  Candidates are deduped canonically — the
    redundancy-elimination cost this incurs is precisely the overhead the
    paper's merging strategy avoids (§1, §3.1.2).
    """
    labs = sorted(set(int(l) for l in vertex_labels))
    out: List[Pattern] = []
    for pat in frequent:
        if max_k is None or pat.k < max_k:
            for v in range(pat.k):
                for lab in labs:
                    out.append(pat.add_vertex(lab, out_to=[v]))
                    out.append(pat.add_vertex(lab, in_from=[v]))
        for i in range(pat.k):
            for j in range(pat.k):
                if i != j and not pat.adj[i, j]:
                    out.append(pat.with_edge(i, j))
    return dedupe_patterns(out)
