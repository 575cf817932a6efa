"""Data-graph representation for FLEXIS.

The data graph is stored as a pair of CSR structures (out- and in-adjacency)
plus a sorted edge-key array for O(log E) vectorized edge-existence queries.
All arrays are plain numpy on the host; `DeviceGraph` holds the int32 torch
mirrors the matcher reads, on one device.  Shapes are static — the matcher
never sees ragged data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DataGraph", "DeviceGraph", "build_graph", "sorted_unique"]


@dataclasses.dataclass(frozen=True)
class DataGraph:
    """Host-side CSR data graph (directed, vertex-labeled).

    Attributes:
      n:          number of vertices.
      labels:     (n,) int32 vertex labels in [0, n_labels).
      out_indptr: (n+1,) int64 CSR row pointers, out-edges.
      out_indices:(E,)  int32 column indices, sorted within each row.
      in_indptr / in_indices: same for the transposed graph.
      edge_keys:  (E,) int64 sorted array of u * n + v for every edge (u, v).
      n_labels:   number of distinct vertex labels.
    """

    n: int
    labels: np.ndarray
    out_indptr: np.ndarray
    out_indices: np.ndarray
    in_indptr: np.ndarray
    in_indices: np.ndarray
    edge_keys: np.ndarray
    n_labels: int
    undirected: bool = False

    @property
    def n_edges(self) -> int:
        return int(self.out_indices.shape[0])

    @property
    def max_out_degree(self) -> int:
        return int(np.max(np.diff(self.out_indptr))) if self.n else 0

    @property
    def max_in_degree(self) -> int:
        return int(np.max(np.diff(self.in_indptr))) if self.n else 0

    def out_degree(self, v: int) -> int:
        return int(self.out_indptr[v + 1] - self.out_indptr[v])

    def neighbors_out(self, v: int) -> np.ndarray:
        return self.out_indices[self.out_indptr[v]: self.out_indptr[v + 1]]

    def neighbors_in(self, v: int) -> np.ndarray:
        return self.in_indices[self.in_indptr[v]: self.in_indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        key = np.int64(u) * self.n + v
        i = np.searchsorted(self.edge_keys, key)
        return bool(i < self.edge_keys.shape[0] and self.edge_keys[i] == key)

    def label_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=self.n_labels)

    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for a in (
                self.labels,
                self.out_indptr,
                self.out_indices,
                self.in_indptr,
                self.in_indices,
                self.edge_keys,
            )
        )


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """int32 torch mirror of `DataGraph`, on one device, read by the matcher.

    Edge-existence queries use a bounded binary search over the CSR rows
    (int32 only) — no int64 edge-key table is shipped to the device.
    """

    n: int
    labels: torch.Tensor
    out_indptr: torch.Tensor
    out_indices: torch.Tensor
    in_indptr: torch.Tensor
    in_indices: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.labels.device

    @classmethod
    def from_host(cls, g: DataGraph, device="cuda") -> "DeviceGraph":
        if g.n_edges > np.iinfo(np.int32).max:
            raise ValueError("graphs beyond int32 edge counts must be sharded first")
        dev = resolve_device(device)
        out_indices, in_indices = g.out_indices, g.in_indices
        if g.n_edges == 0:
            # edgeless graph: keep index arrays non-empty so the matcher's
            # gathers stay well-formed; the sentinel is unreachable because
            # every degree is 0 (indptr is all zeros).
            out_indices = in_indices = np.zeros(1, np.int32)

        def up(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

        return cls(
            n=g.n,
            labels=up(g.labels),
            out_indptr=up(g.out_indptr),
            out_indices=up(out_indices),
            in_indptr=up(g.in_indptr),
            in_indices=up(in_indices),
        )


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by one sort: numpy ≥ 2.3's ``np.unique`` finds
    the unique values with a hash table first, which took 37 s for 19 M
    distinct int64 edge keys under numpy 2.3.5, where a sort of 20 M took
    0.4 s."""
    keys = np.sort(keys)
    if keys.size:
        keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    return keys


def _csr_from_sorted_keys(n: int, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of the edges ``keys = src·n + dst``, sorted ascending."""
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys // n, minlength=n), out=indptr[1:])
    return indptr, (keys % n).astype(np.int32)


def _csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    # one sort of the keys src·n + dst orders edges as a lexsort by (src,
    # dst) would, in a fraction of its time on 10⁸ edges
    return _csr_from_sorted_keys(n, np.sort(src * n + dst))


def build_graph(
    n: int,
    edges: Sequence[Tuple[int, int]] | np.ndarray,
    labels: Sequence[int] | np.ndarray,
    *,
    undirected: bool = False,
    n_labels: Optional[int] = None,
) -> DataGraph:
    """Build a `DataGraph` from an edge list.

    Self-loops and duplicate edges are dropped. If `undirected`, every edge is
    inserted in both directions (the paper's loader is undirected while its
    matcher is directed — symmetrizing reproduces that behaviour exactly).
    """
    labels = np.asarray(labels, dtype=np.int32)
    if labels.shape != (n,):
        raise ValueError(f"labels must have shape ({n},), got {labels.shape}")
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size:
        if edges.min() < 0 or edges.max() >= n:
            raise ValueError("edge endpoint out of range")
    src, dst = edges[:, 0], edges[:, 1]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    # dedupe
    keys = sorted_unique(src * n + dst)
    out_indptr, out_indices = _csr_from_sorted_keys(n, keys)
    if undirected:   # a symmetric edge set: the transpose is the same CSR
        in_indptr, in_indices = out_indptr, out_indices
    else:
        in_indptr, in_indices = _csr_from_edges(n, keys % n, keys // n)
    return DataGraph(
        n=n,
        labels=labels,
        out_indptr=out_indptr,
        out_indices=out_indices,
        in_indptr=in_indptr,
        in_indices=in_indices,
        edge_keys=keys,   # sorted by sorted_unique
        n_labels=int(n_labels if n_labels is not None else (labels.max() + 1 if n else 0)),
        undirected=undirected,
    )
