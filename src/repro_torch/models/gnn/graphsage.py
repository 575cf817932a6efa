"""GraphSAGE (Hamilton et al., arXiv:1706.02216), mean aggregator
(``repro.models.gnn.graphsage`` on PyTorch).

h_v^{l+1} = relu(W_self · h_v + W_neigh · mean_{u∈N(v)} h_u), L2-normalised.

The reference computes each layer's neighbour mean as ``gather`` +
``scatter_mean`` over the edge list.  Here `sage_apply` builds the padded
in-neighbour table once per batch (`in_neighbor_table`: row v holds the
sources of the edges into v in edge order) and each layer is one
`gather_aggregate(h, nbrs, mean=True)`: the kernel on the card, its plain
version on the CPU, so both devices run the same algorithm.  The sum runs
in f32 and rounds once to bf16, where the reference's bf16 scatter rounds
after every add; the two agree within bf16 tolerance (f32 features agree
to f32 rounding, ``tests/test_torch_gnn.py``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...kernels.gather_aggregate.ops import gather_aggregate, in_neighbor_table
from ..common import Dense
from .common import GraphBatch, node_class_loss

__all__ = ["SAGEConfig", "SAGE", "sage_init", "sage_apply", "sage_loss"]


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    d_in: int
    d_hidden: int = 128
    n_layers: int = 2
    n_classes: int = 41
    aggregator: str = "mean"


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
              device=None) -> SAGE:
    model = SAGE(cfg, device=device)
    model.reset_parameters(generator)
    return model


@torch.no_grad()
def sage_apply(model: SAGE, gb: GraphBatch) -> torch.Tensor:
    cfg = model.cfg
    h = gb.x.to(torch.bfloat16)
    nbrs = in_neighbor_table(gb.edge_src, gb.edge_dst, gb.edge_mask,
                             h.shape[0])
    for l in range(cfg.n_layers):
        agg = gather_aggregate(h, nbrs, mean=True)
        h = torch.relu(model.self_[l](h) + model.neigh[l](agg))
        h32 = h.float()
        norm = torch.linalg.vector_norm(h32, dim=-1, keepdim=True)
        h = (h32 / norm.clamp(min=1e-6)).to(h.dtype)
    return model.head(h)


def sage_loss(model: SAGE, gb: GraphBatch) -> torch.Tensor:
    return node_class_loss(sage_apply(model, gb), gb.targets, gb.node_mask)
