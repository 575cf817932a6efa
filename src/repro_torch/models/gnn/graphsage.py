"""GraphSAGE (Hamilton et al., arXiv:1706.02216), mean aggregator
(``repro.models.gnn.graphsage`` on PyTorch).

h_v^{l+1} = relu(W_self · h_v + W_neigh · mean_{u∈N(v)} h_u), L2-normalised.

The reference computes each layer's neighbour mean as ``gather`` +
``scatter_mean`` over the edge list.  Here `sage_apply` builds the
in-neighbour CSR once per batch (`in_csr`: row v lists the sources of the
edges into v in edge order, one stable sort by destination) and each layer
is one `gather_aggregate_csr(h, indptr, src, mean=True)`: the kernel on
the card, its plain version on the CPU, so both devices run the same
algorithm, on every shape.  The CSR holds each edge once, whatever the
degrees: at ogb_products' R-MAT stand-in (2.4 M nodes, 62 M edges, hub
in-degrees of tens of thousands) a padded (N, Dmax) table would not fit a
card.  The sum runs in f32 and rounds once to bf16, where the reference's
bf16 scatter rounds after every add; the two agree within bf16 tolerance
(f32 features agree to f32 rounding, ``tests/test_torch_gnn.py``).  Under
autograd the aggregate's backward is the transpose kernel over the CSR's
transpose; only layer 1's input takes a gradient there (the features
``x`` take none).  With ``graph_level`` (the ``molecule`` shape) the last
layer's node states are mean-pooled per graph (`segment_pool`) before the
``head``, and the loss is the graph regression's.  `sage_init` builds f32
masters for training (``train=True``) or frozen bf16 serving weights.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...kernels.gather_aggregate.ops import gather_aggregate_csr, in_csr
from ..common import Dense, for_serving
from .common import (
    GraphBatch, graph_regression_loss, node_class_loss, segment_pool,
)

__all__ = ["SAGEConfig", "SAGE", "sage_init", "sage_apply", "sage_loss"]


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    d_in: int
    d_hidden: int = 128
    n_layers: int = 2
    n_classes: int = 41
    aggregator: str = "mean"
    graph_level: bool = False   # pool to per-graph output (molecule cells)


class SAGE(nn.Module):
    """``self{l}`` / ``neigh{l}`` dense pairs and the ``head``, the
    reference's parameter names."""

    def __init__(self, cfg: SAGEConfig, *, device=None):
        super().__init__()
        if cfg.aggregator != "mean":
            raise NotImplementedError(
                f"aggregator {cfg.aggregator!r}: only 'mean' (the "
                f"reference's only one)")
        self.cfg = cfg
        d = cfg.d_in
        self.self_ = nn.ModuleList()
        self.neigh = nn.ModuleList()
        for _ in range(cfg.n_layers):
            self.self_.append(Dense(d, cfg.d_hidden, device=device))
            self.neigh.append(Dense(d, cfg.d_hidden, device=device))
            d = cfg.d_hidden
        self.head = Dense(d, cfg.n_classes, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for s, n in zip(self.self_, self.neigh):
            s.reset_parameters(generator)
            n.reset_parameters(generator)
        self.head.reset_parameters(generator)


def sage_init(cfg: SAGEConfig, generator: torch.Generator, *,
              device=None, train: bool = False) -> SAGE:
    """Random weights from ``generator``: f32 trainable masters with
    ``train``, else `for_serving`."""
    model = SAGE(cfg, device=device)
    model.reset_parameters(generator)
    return model if train else for_serving(model)


def sage_apply(model: SAGE, gb: GraphBatch) -> torch.Tensor:
    cfg = model.cfg
    h = gb.x.to(torch.bfloat16)
    indptr, src = in_csr(gb.edge_src, gb.edge_dst, gb.edge_mask, h.shape[0])
    for l in range(cfg.n_layers):
        agg = gather_aggregate_csr(h, indptr, src, mean=True)
        h = torch.relu(model.self_[l](h) + model.neigh[l](agg))
        h32 = h.float()
        norm = torch.linalg.vector_norm(h32, dim=-1, keepdim=True)
        h = (h32 / norm.clamp(min=1e-6)).to(h.dtype)
    if cfg.graph_level:
        h = segment_pool(h, gb.graph_ids, gb.node_mask, gb.n_graphs)
    return model.head(h)


def sage_loss(model: SAGE, gb: GraphBatch) -> torch.Tensor:
    out = sage_apply(model, gb)
    if model.cfg.graph_level:
        return graph_regression_loss(out[:, 0], gb.targets)
    return node_class_loss(out, gb.targets, gb.node_mask)
