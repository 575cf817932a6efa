"""Neighbour sampler for the minibatch_lg cell (``repro.data.sampler``).

GraphSAGE-style layered uniform sampling from CSR on the host (numpy),
emitting static-shape padded blocks: seeds → fanout[0] neighbours →
fanout[1] neighbours, with local re-indexing, padding masks, and per-seed
loss nodes.  The numpy draws are the reference's, in the same order, so a
block equals the reference's bit for bit.  `block_graph_batch` turns a
block into the model's `GraphBatch` on the features' device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import DataGraph
from ..models.gnn.common import GraphBatch

__all__ = ["SampledBlock", "NeighborSampler", "block_graph_batch"]


@dataclasses.dataclass
class SampledBlock:
    """Padded sampled subgraph (the GNN arch's minibatch_lg input)."""

    node_ids: np.ndarray    # (N_pad,) global ids (-1 pad)
    x_rows: np.ndarray      # (N_pad,) row into the feature matrix (0 for pad)
    edge_src: np.ndarray    # (E_pad,) local indices
    edge_dst: np.ndarray    # (E_pad,)
    edge_mask: np.ndarray   # (E_pad,) bool
    node_mask: np.ndarray   # (N_pad,) bool — True for seeds (loss nodes)
    n_real_nodes: int
    n_real_edges: int


class NeighborSampler:
    def __init__(self, graph: DataGraph, *, fanout: Sequence[int] = (15, 10),
                 batch_nodes: int = 1024, seed: int = 0):
        self.g = graph
        self.fanout = tuple(fanout)
        self.batch = batch_nodes
        self.seed = seed
        # static pad sizes (the arch's input spec derives the same)
        n_cap = batch_nodes
        e_cap = 0
        layer = batch_nodes
        for f in self.fanout:
            e_cap += layer * f
            layer *= f
            n_cap += layer
        self.node_cap = n_cap
        self.edge_cap = e_cap

    def _sample_neighbors(self, rng, frontier: np.ndarray, fanout: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """For each vertex, up to `fanout` uniform out-neighbours (without
        replacement when degree ≥ fanout)."""
        srcs, dsts = [], []
        for v in frontier:
            nbrs = self.g.neighbors_out(int(v))
            if nbrs.size == 0:
                continue
            if nbrs.size > fanout:
                picked = rng.choice(nbrs, size=fanout, replace=False)
            else:
                picked = nbrs
            srcs.append(np.full(picked.size, v, np.int64))
            dsts.append(picked.astype(np.int64))
        if not srcs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(srcs), np.concatenate(dsts)

    def sample(self, step: int) -> SampledBlock:
        rng = np.random.default_rng((self.seed, step))
        seeds = rng.choice(self.g.n, size=min(self.batch, self.g.n),
                           replace=False)
        nodes = list(seeds)
        index = {int(v): i for i, v in enumerate(seeds)}
        es, ed = [], []
        frontier = seeds
        for f in self.fanout:
            s, d = self._sample_neighbors(rng, frontier, f)
            new_frontier = []
            for sv, dv in zip(s, d):
                dv = int(dv)
                if dv not in index:
                    index[dv] = len(nodes)
                    nodes.append(dv)
                    new_frontier.append(dv)
                # message flows neighbour → seed side (dst aggregates src)
                es.append(index[dv])
                ed.append(index[int(sv)])
            frontier = np.array(new_frontier, np.int64) if new_frontier \
                else np.zeros(0, np.int64)

        n_real, e_real = len(nodes), len(es)
        assert n_real <= self.node_cap and e_real <= self.edge_cap
        node_ids = np.full(self.node_cap, -1, np.int64)
        node_ids[:n_real] = nodes
        x_rows = np.maximum(node_ids, 0)
        edge_src = np.zeros(self.edge_cap, np.int32)
        edge_dst = np.zeros(self.edge_cap, np.int32)
        edge_mask = np.zeros(self.edge_cap, bool)
        edge_src[:e_real] = es
        edge_dst[:e_real] = ed
        edge_mask[:e_real] = True
        node_mask = np.zeros(self.node_cap, bool)
        node_mask[: seeds.size] = True  # loss on seed nodes only
        return SampledBlock(node_ids=node_ids, x_rows=x_rows,
                            edge_src=edge_src, edge_dst=edge_dst,
                            edge_mask=edge_mask, node_mask=node_mask,
                            n_real_nodes=n_real, n_real_edges=e_real)

    def blocks(self, *, start_step: int = 0) -> Iterator[SampledBlock]:
        step = start_step
        while True:
            yield self.sample(step)
            step += 1


def block_graph_batch(block: SampledBlock, features: torch.Tensor,
                      labels: torch.Tensor) -> GraphBatch:
    """The block as a `GraphBatch` on the features' device: x and targets
    are the rows of the (n, F) features and (n,) labels at ``x_rows``."""
    dev = features.device

    def up(a):
        return torch.as_tensor(a).to(dev)

    rows = up(block.x_rows)
    return GraphBatch(
        x=features[rows], edge_src=up(block.edge_src),
        edge_dst=up(block.edge_dst), edge_mask=up(block.edge_mask),
        node_mask=up(block.node_mask),
        graph_ids=torch.zeros(rows.shape[0], dtype=torch.int32, device=dev),
        n_graphs=1, targets=labels[rows])
