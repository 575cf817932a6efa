"""GNN-family arch wrapper (``repro.configs.gnn_arch``) — the four shapes
shared by the GNN archs:

  full_graph_sm   2,708 nodes / 10,556 edges / d_feat 1,433 (full-batch)
  minibatch_lg    232,965-node graph, sampled blocks: 1,024 seeds, fanout 15-10
  ogb_products    2,449,029 nodes / 61,859,140 edges / d_feat 100 (full-batch)
  molecule        30 nodes / 64 edges × batch 128 (batched small graphs)

Geometric models (SchNet, NequIP: ``needs_positions``) consume
positions; every graph here is a synthetic stand-in built from a seed.
Every arch runs full_graph_sm, minibatch_lg and molecule, and GraphSAGE
also ogb_products (`GNNArch.ported_shapes`): the forward loss and the
training step (loss + grad + AdamW with the arch's `AdamWConfig`, lr 1e-3,
on a model built with ``train=True``), the reference's only step for a GNN
cell.  schnet, nequip and graphcast at ogb_products raise
`NotImplementedError` naming their largest edge tensor and its bytes
(`OGB_EDGE_TENSORS`): their steps outgrow one 80 GB card and need a
node-sharded run over several cards (ROADMAP.md Queue 1 item 7).

  * full_graph_sm, ogb_products and molecule: `inputs` builds the shape's
    one batch on the device — an undirected R-MAT graph with Cora's 2 708
    vertices and 10 556 directed edges, or with ogb-products' 2 449 029
    and 61 859 140, or 128 connected molecules of 30 atoms and 64 bonds (a
    chain plus distinct random pairs, both directions) — with features
    (N(0, 1) f32), positions and targets (class ids uniform in n_out)
    drawn from a seed, padded to `_pad`'s sizes with the masks false on
    the padding;
  * minibatch_lg: the graph is an R-MAT stand-in with Reddit's vertex and
    directed edge counts (`graph`), its features and labels (`node_data`)
    and positions (`node_pos`) are drawn from a seed, and `sampler` cuts
    the blocks (``data.sampler.block_graph_batch``).
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
from ..models.sharding import P, PartitionSpec
from ..train.optimizer import AdamWConfig, AdamWState
from ..train.step import make_train_step
from .base import (ShapeCell, TensorSpec, abstract_params,
                   default_param_pspecs)

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
# the shapes every GNN arch runs (`GNNArch.ported_shapes` adds more)
PORTED_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
# ogb_products: the largest edge tensor of each arch's train step, which
# with the step's other edge activations and gradients outgrows one 80 GB
# card — (what it is, its width, bytes an element); graphcast's processor
# concatenates three of its states, (E, 3·512)
OGB_EDGE_TENSORS = {
    "graphcast": ("the processor's edge state (E, 512) bf16", 512, 2),
    "schnet": ("the RBF expansion (E, 300) bf16", 300, 2),
    "nequip": ("the rank-2 messages (E, 32·9) f32", 32 * 9, 4),
}
NODE_AXES = ("pod", "data")

_REDUCED_META = dict(n_nodes=64, n_edges=256, d_feat=8, n_out=4,
                     graph_level=False, n_graphs=1)

# molecule: atoms and bonds of each of the shape's n_graphs molecules
MOLECULE_ATOMS, MOLECULE_BONDS = 30, 64
# node_pos draws from a stream of its own beside node_data's
_POS_STREAM = 0x9E3779B9


@dataclasses.dataclass
class GNNArch:
    """model_builder(meta) → (cfg, init_fn(generator, device, train),
    loss_fn(model, gb))."""

    arch_name: str
    model_builder: Callable
    needs_positions: bool = False
    opt: AdamWConfig = dataclasses.field(
        default_factory=lambda: AdamWConfig(lr=1e-3))
    family: str = "gnn"
    ported_shapes: Tuple[str, ...] = PORTED_SHAPES

    @property
    def name(self) -> str:
        return self.arch_name

    def shapes(self) -> Dict[str, ShapeCell]:
        return dict(GNN_SHAPES)

    def meta(self, shape: str, reduced: bool = False) -> dict:
        if not reduced:
            return GNN_SHAPES[shape].meta
        meta = dict(_REDUCED_META)
        if shape == "molecule":
            meta.update(graph_level=True, n_graphs=4, n_out=1)
        return meta

    def _ported(self, shape: str) -> None:
        if shape in self.ported_shapes:
            return
        if shape == "ogb_products" and self.arch_name in OGB_EDGE_TENSORS:
            what, width, size = OGB_EDGE_TENSORS[self.arch_name]
            E = GNN_SHAPES[shape].meta["n_edges"]
            extra = (f"; its (E, {3 * width}) concatenation "
                     f"{E * 3 * width * size / 1e9:.1f} GB"
                     if self.arch_name == "graphcast" else "")
            raise NotImplementedError(
                f"{self.arch_name} at {shape}: {what} is "
                f"{E * width * size / 1e9:.1f} GB at E = {E}{extra}; a "
                f"train step holds it beside the other edge activations "
                f"and their gradients, past one 80 GB card: it needs a "
                f"node-sharded run over several cards (ROADMAP.md Queue 1 "
                f"item 7)")
        raise NotImplementedError(
            f"{self.arch_name}: only {self.ported_shapes} is ported yet "
            f"(ROADMAP.md)")

    def _build(self, shape: str, reduced: bool = False):
        self._ported(shape)
        return self.model_builder(self.meta(shape, reduced))

    def config(self, shape: str, reduced: bool = False):
        return self._build(shape, reduced)[0]

    def init(self, shape: str, generator: torch.Generator, *,
             reduced: bool = False, device="cuda", train: bool = False):
        """The model on ``device`` (raises for CUDA without a card); f32
        trainable masters with ``train``."""
        init_fn = self._build(shape, reduced)[1]
        return init_fn(generator, resolve_device(device), train=train)

    # ---- partition specs (the reference's) ----------------------------------
    def _meta_model(self, shape: str, reduced: bool):
        return self._build(shape, reduced)[1](torch.Generator(), "meta",
                                              train=True)

    def abstract_params(self, shape: str = "full_graph_sm", *,
                     reduced: bool = False):
        return abstract_params(self._meta_model(shape, reduced))

    def param_pspecs(self, shape: str = "full_graph_sm", *,
                     reduced: bool = False) -> Dict[str, PartitionSpec]:
        """GNN parameters are small: replicated; the nodes carry the
        sharding."""
        return default_param_pspecs(self._meta_model(shape, reduced))

    def opt_pspecs(self, shape: str = "full_graph_sm", *,
                   reduced: bool = False) -> AdamWState:
        ps = self.param_pspecs(shape, reduced=reduced)
        return AdamWState(step=P(), mu=ps, nu=ps)

    def input_pspecs(self, shape: str) -> Dict[str, Dict[str, PartitionSpec]]:
        """Every batch field over the node axes (edges too: the reference's
        ``NODE_AXES`` on dimension 0), the rest replicated."""
        return {"batch": {k: P(NODE_AXES, *([None] * (len(v.shape) - 1)))
                          for k, v in self.input_specs(shape).items()}}

    # ---- inputs ------------------------------------------------------------
    @staticmethod
    def _pad(n: int, mult: int = 512) -> int:
        """Nodes/edges padded to mesh-divisible sizes (masked anyway)."""
        return -(-n // mult) * mult

    @staticmethod
    def _targets_spec(meta: dict, N: int) -> TensorSpec:
        if meta["graph_level"]:
            return TensorSpec((meta["n_graphs"],), torch.float32)
        return TensorSpec((N,), torch.float32 if meta["n_out"] == 1
                          else torch.int32)

    def input_specs(self, shape: str, *, reduced: bool = False
                    ) -> Dict[str, TensorSpec]:
        """The reference's ``_batch_specs`` (padded sizes), by field."""
        self._ported(shape)
        meta = self.meta(shape, reduced)
        N, E = self._pad(meta["n_nodes"]), self._pad(meta["n_edges"])
        specs = {"x": TensorSpec((N, meta["d_feat"]), torch.float32),
                 "edge_src": TensorSpec((E,), torch.int32),
                 "edge_dst": TensorSpec((E,), torch.int32),
                 "edge_mask": TensorSpec((E,), torch.bool),
                 "node_mask": TensorSpec((N,), torch.bool),
                 "graph_ids": TensorSpec((N,), torch.int32),
                 "targets": self._targets_spec(meta, N)}
        if self.needs_positions:
            specs["pos"] = TensorSpec((N, 3), torch.float32)
        return specs

    def reduced_inputs(self, shape: str, device="cuda") -> GraphBatch:
        """The reference's ``reduced_inputs`` batch, draw for draw (targets
        first, positions last), on ``device``."""
        self._ported(shape)
        device = resolve_device(device)
        meta = self.meta(shape, reduced=True)
        r = np.random.default_rng(0)
        N, E = meta["n_nodes"], meta["n_edges"]
        if meta["graph_level"]:
            tgt = r.normal(size=(meta["n_graphs"],)).astype(np.float32)
        elif meta["n_out"] == 1:
            tgt = r.normal(size=(N,)).astype(np.float32)
        else:
            tgt = r.integers(0, meta["n_out"], N).astype(np.int32)
        x = r.normal(size=(N, meta["d_feat"])).astype(np.float32)
        src = r.integers(0, N, E).astype(np.int32)
        dst = r.integers(0, N, E).astype(np.int32)
        gids = np.sort(r.integers(0, meta["n_graphs"], N)).astype(np.int32)
        pos = (r.normal(size=(N, 3)).astype(np.float32)
               if self.needs_positions else None)

        def up(a):
            return None if a is None else torch.as_tensor(a).to(device)

        return GraphBatch(x=up(x), edge_src=up(src), edge_dst=up(dst),
                          edge_mask=up(np.ones(E, bool)),
                          node_mask=up(np.ones(N, bool)), graph_ids=up(gids),
                          n_graphs=meta["n_graphs"], targets=up(tgt),
                          pos=up(pos))

    def inputs(self, shape: str, *, seed: int = 0, device="cuda"
               ) -> GraphBatch:
        """The full-size batch of full_graph_sm, ogb_products or molecule
        on ``device`` (module docstring); minibatch_lg's come from
        `sampler`."""
        self._ported(shape)
        if shape == "minibatch_lg":
            raise ValueError("minibatch_lg batches are sampled blocks: "
                             "sampler(graph(...)) and "
                             "data.sampler.block_graph_batch")
        device = resolve_device(device)
        meta = self.meta(shape)
        if shape == "molecule":
            src, dst = molecule_edges(meta["n_graphs"], seed=seed)
            gids = np.repeat(np.arange(meta["n_graphs"], dtype=np.int32),
                             MOLECULE_ATOMS)
        else:
            g = rmat_undirected_graph(meta["n_nodes"], meta["n_edges"],
                                      seed=seed)
            src = np.repeat(np.arange(g.n, dtype=np.int32),
                            np.diff(g.out_indptr))
            dst = g.out_indices.astype(np.int32)
            gids = np.zeros(g.n, np.int32)
        N, E = meta["n_nodes"], meta["n_edges"]
        if src.size != E or gids.size != N:
            raise AssertionError(f"{shape}: built {gids.size} nodes and "
                                 f"{src.size} edges, not {N} and {E}")
        Np, Ep = self._pad(N), self._pad(E)

        def padded(a, n, fill=0):
            out = torch.full((n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                             device=device)
            out[:a.shape[0]] = a
            return out

        def up(a, n):
            return padded(torch.as_tensor(a).to(device), n)

        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((N, meta["d_feat"]), generator=gen, device=device)
        spec = self._targets_spec(meta, N)
        if spec.dtype == torch.int32:
            tgt = torch.randint(0, meta["n_out"], spec.shape, generator=gen,
                                device=device, dtype=torch.int32)
        else:
            tgt = torch.randn(spec.shape, generator=gen, device=device)
        pos = (torch.randn((N, 3), generator=gen, device=device)
               if self.needs_positions else None)
        ar = torch.arange
        return GraphBatch(
            x=padded(x, Np), edge_src=up(src, Ep), edge_dst=up(dst, Ep),
            edge_mask=ar(Ep, device=device) < E,
            node_mask=ar(Np, device=device) < N, graph_ids=up(gids, Np),
            n_graphs=meta["n_graphs"],
            targets=tgt if meta["graph_level"] else padded(tgt, Np),
            pos=None if pos is None else padded(pos, Np))

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

    def node_pos(self, n: int, *, seed: int = 0, device="cuda"
                 ) -> torch.Tensor:
        """(n, 3) f32 normal positions, drawn on ``device`` from a stream of
        their own for ``seed`` (not `node_data`'s)."""
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed + _POS_STREAM)
        return torch.randn((n, 3), generator=g, device=device)

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
        """``step(model, opt_state, gb) → (loss, model, opt_state)``."""
        return make_train_step(self.loss_fn(shape, reduced=reduced), self.opt)


def molecule_edges(n_graphs: int, *, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 of ``n_graphs`` connected molecules, graph by graph:
    each is a chain of its MOLECULE_ATOMS atoms plus the other bonds (up to
    MOLECULE_BONDS) as distinct atom pairs drawn from ``seed``; its bonds
    one way, then the same pairs the other way."""
    atoms = MOLECULE_ATOMS
    rng = np.random.default_rng(seed)
    lo, hi = np.triu_indices(atoms, k=1)
    chain = hi == lo + 1
    others = np.flatnonzero(~chain)
    extra = MOLECULE_BONDS - (atoms - 1)
    src, dst = [], []
    for g in range(n_graphs):
        pick = np.concatenate([np.flatnonzero(chain), np.sort(
            rng.choice(others, extra, replace=False))])
        a, b = lo[pick] + g * atoms, hi[pick] + g * atoms
        src += [a, b]
        dst += [b, a]
    return (np.concatenate(src).astype(np.int32),
            np.concatenate(dst).astype(np.int32))
