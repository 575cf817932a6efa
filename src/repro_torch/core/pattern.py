"""Pattern graphs — the tiny (k ≤ 8) labeled directed graphs FLEXIS mines.

Patterns live on the host as dense boolean adjacency + label vector; the
number of live patterns at any mining level is 10^2–10^4, so host numpy is
the right tool (control plane). Device work never touches these objects —
`plan.py` compiles each pattern into a static matching plan first.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np

__all__ = ["Pattern", "pattern_from_edges", "paper_fig1"]


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A directed, vertex-labeled pattern graph.

    adj[i, j] == True  ⇔  edge i → j.  labels[i] is vertex i's label.
    """

    adj: np.ndarray  # (k, k) bool
    labels: np.ndarray  # (k,) int32

    def __post_init__(self):
        adj = np.asarray(self.adj, dtype=bool)
        labels = np.asarray(self.labels, dtype=np.int32)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError("adj must be square")
        if labels.shape != (adj.shape[0],):
            raise ValueError("labels/adj size mismatch")
        if np.any(np.diag(adj)):
            raise ValueError("self-loops not allowed in patterns")
        object.__setattr__(self, "adj", adj)
        object.__setattr__(self, "labels", labels)

    # -- basic properties ---------------------------------------------------
    @property
    def k(self) -> int:
        return int(self.adj.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.adj.sum())

    def undirected_adj(self) -> np.ndarray:
        return self.adj | self.adj.T

    def degree(self) -> np.ndarray:
        """Undirected degree per vertex."""
        u = self.undirected_adj()
        return u.sum(axis=0)

    def is_connected(self) -> bool:
        if self.k == 0:
            return True
        u = self.undirected_adj()
        seen = np.zeros(self.k, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            v = stack.pop()
            for w in np.nonzero(u[v])[0]:
                if not seen[w]:
                    seen[w] = True
                    stack.append(int(w))
        return bool(seen.all())

    def is_clique(self) -> bool:
        """Clique in the undirected sense: every vertex pair joined."""
        u = self.undirected_adj()
        return bool(np.all(u | np.eye(self.k, dtype=bool)))

    # -- manipulation --------------------------------------------------------
    def permuted(self, perm: Sequence[int]) -> "Pattern":
        """Return the pattern with vertex i renamed to perm[i].

        new_adj[perm[i], perm[j]] = adj[i, j]; equivalently composing with the
        inverse permutation on both axes.
        """
        perm = np.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.k)
        return Pattern(self.adj[np.ix_(inv, inv)], self.labels[inv])

    def remove_vertex(self, v: int) -> "Pattern":
        keep = [i for i in range(self.k) if i != v]
        return Pattern(self.adj[np.ix_(keep, keep)], self.labels[keep])

    def add_vertex(
        self, label: int, out_to: Iterable[int] = (), in_from: Iterable[int] = ()
    ) -> "Pattern":
        k = self.k
        adj = np.zeros((k + 1, k + 1), dtype=bool)
        adj[:k, :k] = self.adj
        for j in out_to:
            adj[k, j] = True
        for j in in_from:
            adj[j, k] = True
        return Pattern(adj, np.concatenate([self.labels, [label]]))

    def with_edge(self, i: int, j: int) -> "Pattern":
        adj = self.adj.copy()
        adj[i, j] = True
        return Pattern(adj, self.labels)

    def edges(self) -> List[Tuple[int, int]]:
        return [(int(i), int(j)) for i, j in zip(*np.nonzero(self.adj))]

    # -- identity ------------------------------------------------------------
    def key(self) -> Tuple:
        """Raw (non-canonical) structural key."""
        return (self.k, self.labels.tobytes(), np.packbits(self.adj).tobytes())

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, Pattern) and self.key() == other.key()

    def __repr__(self):
        return f"Pattern(k={self.k}, labels={self.labels.tolist()}, edges={self.edges()})"


def pattern_from_edges(
    labels: Sequence[int], edges: Iterable[Tuple[int, int]], *, bidir: bool = False
) -> Pattern:
    labels = np.asarray(labels, dtype=np.int32)
    k = labels.shape[0]
    adj = np.zeros((k, k), dtype=bool)
    for i, j in edges:
        adj[i, j] = True
        if bidir:
            adj[j, i] = True
    return Pattern(adj, labels)


def paper_fig1():
    """The running example of the paper (Figure 1).

    Returns (P1, D_edges, D_labels): pattern P1 = u1-u2-u3 with double arrows
    and labels (A, B, A); data graph D with d1..d4 labeled A, d5..d7 labeled B
    and double-arrow edges d1-d5, d2-d5, d2-d6, d3-d6, d3-d7, d4-d7.
    Ground truth (paper §2.4): MNI = 3, MIS = 2, mIS ∈ {1, 2}.
    """
    A, B = 0, 1
    p1 = pattern_from_edges([A, B, A], [(0, 1), (1, 2)], bidir=True)
    d_labels = [A, A, A, A, B, B, B]  # d1..d4=A, d5..d7=B (0-indexed)
    und = [(0, 4), (1, 4), (1, 5), (2, 5), (2, 6), (3, 6)]
    d_edges = und + [(b, a) for a, b in und]
    return p1, d_edges, d_labels
