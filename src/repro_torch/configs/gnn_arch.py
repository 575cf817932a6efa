"""GNN-family arch wrapper (``repro.configs.gnn_arch``) — the four shapes
shared by the GNN archs:

  full_graph_sm   2,708 nodes / 10,556 edges / d_feat 1,433 (full-batch)
  minibatch_lg    232,965-node graph, sampled blocks: 1,024 seeds, fanout 15-10
  ogb_products    2,449,029 nodes / 61,859,140 edges / d_feat 100 (full-batch)
  molecule        30 nodes / 64 edges × batch 128 (batched small graphs)

The port runs the forward loss of minibatch_lg (one sampled block); the
training step (loss + grad + AdamW) and the other three shapes raise
`NotImplementedError` (ROADMAP.md).  The minibatch_lg graph is an R-MAT
stand-in with Reddit's vertex and directed edge counts (`graph`), its
features and labels are drawn from a seed (`node_data`), and `sampler`
cuts the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.graph import DataGraph
from ..data.sampler import NeighborSampler
from ..data.synthetic import rmat_undirected_graph
from ..device import resolve_device
from ..models.gnn.common import GraphBatch
from .base import ShapeCell, TensorSpec

GNN_SHAPES: Dict[str, ShapeCell] = {
    "full_graph_sm": ShapeCell("full_graph_sm", "train", dict(
        n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7,
        graph_level=False, n_graphs=1)),
    "minibatch_lg": ShapeCell("minibatch_lg", "train", dict(
        # sampled block: 1024 seeds × fanout (15, 10)
        n_nodes=1024 * (1 + 15 + 150), n_edges=1024 * 15 + 1024 * 15 * 10,
        d_feat=602, n_out=41, graph_level=False, n_graphs=1,
        seeds=1024, fanout=(15, 10), graph_nodes=232_965,
        graph_edges=114_615_892)),
    "ogb_products": ShapeCell("ogb_products", "train", dict(
        n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_out=47,
        graph_level=False, n_graphs=1)),
    "molecule": ShapeCell("molecule", "train", dict(
        n_nodes=30 * 128, n_edges=64 * 2 * 128, d_feat=16, n_out=1,
        graph_level=True, n_graphs=128)),
}
PORTED_SHAPES = ("minibatch_lg",)

_REDUCED_META = dict(n_nodes=64, n_edges=256, d_feat=8, n_out=4, n_graphs=1)


@dataclasses.dataclass
class GNNArch:
    """model_builder(meta) → (cfg, init_fn(generator, device), loss_fn(model, gb))."""

    arch_name: str
    model_builder: Callable

    @property
    def name(self) -> str:
        return self.arch_name

    def shapes(self) -> Dict[str, ShapeCell]:
        return dict(GNN_SHAPES)

    def meta(self, shape: str, reduced: bool = False) -> dict:
        return dict(_REDUCED_META) if reduced else GNN_SHAPES[shape].meta

    @staticmethod
    def _ported(shape: str) -> None:
        if shape not in PORTED_SHAPES:
            raise NotImplementedError(
                f"{shape}: only {PORTED_SHAPES} is ported yet (ROADMAP.md)")

    def _build(self, shape: str, reduced: bool = False):
        self._ported(shape)
        return self.model_builder(self.meta(shape, reduced))

    def config(self, shape: str, reduced: bool = False):
        return self._build(shape, reduced)[0]

    def init(self, shape: str, generator: torch.Generator, *,
             reduced: bool = False, device="cuda"):
        """The model on ``device`` (raises for CUDA without a card)."""
        init_fn = self._build(shape, reduced)[1]
        return init_fn(generator, resolve_device(device))

    # ---- inputs ------------------------------------------------------------
    @staticmethod
    def _pad(n: int, mult: int = 512) -> int:
        """Nodes/edges padded to mesh-divisible sizes (masked anyway)."""
        return -(-n // mult) * mult

    def input_specs(self, shape: str, *, reduced: bool = False
                    ) -> Dict[str, TensorSpec]:
        self._ported(shape)
        meta = self.meta(shape, reduced)
        N, E = self._pad(meta["n_nodes"]), self._pad(meta["n_edges"])
        return {"x": TensorSpec((N, meta["d_feat"]), torch.float32),
                "edge_src": TensorSpec((E,), torch.int32),
                "edge_dst": TensorSpec((E,), torch.int32),
                "edge_mask": TensorSpec((E,), torch.bool),
                "node_mask": TensorSpec((N,), torch.bool),
                "graph_ids": TensorSpec((N,), torch.int32),
                "targets": TensorSpec((N,), torch.int32)}

    def reduced_inputs(self, shape: str, device="cuda") -> GraphBatch:
        """The reference's ``reduced_inputs`` batch, draw for draw, on
        ``device``."""
        self._ported(shape)
        device = resolve_device(device)
        meta = self.meta(shape, reduced=True)
        r = np.random.default_rng(0)
        N, E = meta["n_nodes"], meta["n_edges"]
        tgt = r.integers(0, meta["n_out"], N).astype(np.int32)
        x = r.normal(size=(N, meta["d_feat"])).astype(np.float32)
        src = r.integers(0, N, E).astype(np.int32)
        dst = r.integers(0, N, E).astype(np.int32)
        gids = np.sort(r.integers(0, meta["n_graphs"], N)).astype(np.int32)

        def up(a):
            return torch.as_tensor(a).to(device)

        return GraphBatch(x=up(x), edge_src=up(src), edge_dst=up(dst),
                          edge_mask=up(np.ones(E, bool)),
                          node_mask=up(np.ones(N, bool)), graph_ids=up(gids),
                          n_graphs=meta["n_graphs"], targets=up(tgt))

    def graph(self, shape: str = "minibatch_lg", *, seed: int = 0,
              n_edges: Optional[int] = None) -> DataGraph:
        """The sampled cell's graph: undirected R-MAT with the shape's
        vertex count and exactly ``n_edges`` directed edges (default the
        shape's, Reddit's 114 615 892)."""
        meta = self.meta(shape)
        m = meta["graph_edges"] if n_edges is None else n_edges
        return rmat_undirected_graph(meta["graph_nodes"], m, seed=seed)

    def node_data(self, shape: str, n: int, *, seed: int = 0, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n, d_feat) f32 normal features and (n,) int32 class labels,
        drawn on ``device`` from a generator seeded with ``seed``."""
        meta = self.meta(shape)
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((n, meta["d_feat"]), generator=g, device=device)
        y = torch.randint(0, meta["n_out"], (n,), generator=g, device=device,
                          dtype=torch.int32)
        return x, y

    def sampler(self, graph: DataGraph, shape: str = "minibatch_lg", *,
                seed: int = 0) -> NeighborSampler:
        meta = self.meta(shape)
        return NeighborSampler(graph, fanout=meta["fanout"],
                               batch_nodes=meta["seeds"], seed=seed)

    # ---- steps ---------------------------------------------------------------
    def loss_fn(self, shape: str, *, reduced: bool = False) -> Callable:
        """The forward loss ``loss(model, gb)`` of one batch."""
        return self._build(shape, reduced)[2]

    def step_fn(self, shape: str, *, reduced: bool = False) -> Callable:
        raise NotImplementedError(
            f"{shape}: the GNN training step (loss + grad + AdamW) is not "
            f"ported yet (ROADMAP.md)")
