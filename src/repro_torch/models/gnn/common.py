"""GNN substrate (``repro.models.gnn.common`` on PyTorch): padded graph
batches, masked message passing, the small MLP and the node loss.

Scatters use ``index_add_`` in the messages' dtype, as the reference's
``.at[].add``; GraphSAGE's aggregation does not come through here but
through the gather-aggregate kernel (`models/gnn/graphsage`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..common import Dense
from ..transformer import silu

__all__ = ["GraphBatch", "scatter_sum", "scatter_mean", "gather",
           "segment_pool", "MLP", "mlp_init", "mlp_apply", "node_class_loss",
           "graph_regression_loss"]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded, static-shape (possibly batched) graph, on one device.

    x (N, F) node features; edge_src / edge_dst (E,) int message source and
    destination; edge_mask (E,) bool; node_mask (N,) bool; graph_ids (N,)
    int; n_graphs; targets (N,) int labels (or regression targets); pos
    (N, 3) or None.
    """

    x: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    graph_ids: torch.Tensor
    n_graphs: int
    targets: torch.Tensor
    pos: Optional[torch.Tensor] = None


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Masked scatter-add of (E, F) edge messages into (N, F) nodes."""
    msg = torch.where(mask[:, None], messages, torch.zeros_like(messages))
    out = torch.zeros((n_nodes, messages.shape[-1]), dtype=messages.dtype,
                      device=messages.device)
    return out.index_add_(0, dst.long(), msg)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    s = scatter_sum(messages, dst, mask, n_nodes)
    deg = torch.zeros((n_nodes,), dtype=messages.dtype,
                      device=messages.device)
    deg.index_add_(0, dst.long(), mask.to(messages.dtype))
    return s / deg.clamp(min=1)[:, None]


def gather(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return nodes[idx.long()]


def segment_pool(node_feat: torch.Tensor, graph_ids: torch.Tensor,
                 node_mask: torch.Tensor, n_graphs: int, *,
                 mean: bool = True) -> torch.Tensor:
    """Per-graph pooling for batched small graphs."""
    feat = torch.where(node_mask[:, None], node_feat,
                       torch.zeros_like(node_feat))
    s = torch.zeros((n_graphs, node_feat.shape[-1]), dtype=node_feat.dtype,
                    device=node_feat.device).index_add_(0, graph_ids.long(),
                                                        feat)
    if not mean:
        return s
    cnt = torch.zeros((n_graphs,), dtype=node_feat.dtype,
                      device=node_feat.device)
    cnt.index_add_(0, graph_ids.long(), node_mask.to(node_feat.dtype))
    return s / cnt.clamp(min=1)[:, None]


# ---------------------------------------------------------------------------
# small MLP helper
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Dense layers ``l0 … l{n-1}`` (the reference's ``mlp_init`` keys)."""

    def __init__(self, dims: Sequence[int], *, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(a, b, device=device) for a, b in zip(dims[:-1], dims[1:]))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)


def mlp_init(dims: Sequence[int], generator: torch.Generator, *,
             device=None) -> MLP:
    mlp = MLP(dims, device=device)
    mlp.reset_parameters(generator)
    return mlp


def mlp_apply(mlp: MLP, x: torch.Tensor, *, act: Callable = silu,
              final_act: bool = False) -> torch.Tensor:
    n = len(mlp.layers)
    for i, layer in enumerate(mlp.layers):
        x = layer(x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def node_class_loss(logits: torch.Tensor, targets: torch.Tensor,
                    node_mask: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
    per = (logz - gold) * node_mask
    return per.sum() / node_mask.sum().clamp(min=1)


def graph_regression_loss(pred: torch.Tensor, targets: torch.Tensor
                          ) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - targets.float()))
