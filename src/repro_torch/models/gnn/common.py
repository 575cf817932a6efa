"""GNN substrate (``repro.models.gnn.common`` on PyTorch): padded graph
batches, masked message passing, the small MLP and the GNN losses.

Scatters use ``index_add_`` (``scatter_max``: ``index_reduce_``) in the
messages' dtype, as the reference's ``.at[].add`` / ``.at[].max``: on the
CPU one add after another in edge order, as XLA's CPU scatter, and on the
card with atomics, so that a bf16 sum there is not in a fixed order and
may differ from the CPU's by its rounding.  GraphSAGE's aggregation does
not come through here but through the gather-aggregate kernel
(`models/gnn/graphsage`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..common import Dense, silu

__all__ = ["GraphBatch", "scatter_sum", "scatter_mean", "scatter_max",
           "gather", "spread_padding", "segment_pool", "MLP", "mlp_init",
           "reset_dense_layers", "mlp_apply", "node_class_loss", "node_regression_loss",
           "graph_regression_loss"]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded, static-shape (possibly batched) graph, on one device.

    x (N, F) node features; edge_src / edge_dst (E,) int message source and
    destination; edge_mask (E,) bool; node_mask (N,) bool; graph_ids (N,)
    int; n_graphs; targets (N,) int labels, (N,) or (N, V) regression
    targets or (G,) graph targets; pos (N, 3) or None.
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


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Masked scatter-max; a node that no valid edge reaches gets 0."""
    neg = torch.tensor(-1e30, dtype=messages.dtype).item()
    msg = torch.where(mask[:, None], messages,
                      torch.full_like(messages, neg))
    out = torch.full((n_nodes, messages.shape[-1]), neg, dtype=messages.dtype,
                     device=messages.device)
    out.index_reduce_(0, dst.long(), msg, "amax")
    return torch.where(out <= neg / 2, torch.zeros_like(out), out)


def gather(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(nodes, idx, axis=0)``.  ``index_select``, whose backward
    is an ``index_add_``: advanced indexing's backward sorts the indices
    and adds each run of one index serially, 81 ms a (169 984, 512) bf16
    gather at minibatch_lg on the card (PERF.md)."""
    return torch.index_select(nodes, 0, idx)


def spread_padding(graph: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) of the batch's edges with each masked (padding) edge e
    moved to node e mod N at both ends.  A masked edge never reaches a
    node (`scatter_sum` drops it), so every valid output and gradient is
    the same; but padded blocks point their ~80 000 padding edges at node
    0, and their atomic adds into that one row would run one after another
    on the card."""
    n = graph.x.shape[0]
    spread = torch.arange(graph.edge_src.shape[0], device=graph.x.device,
                          dtype=graph.edge_src.dtype) % n
    return (torch.where(graph.edge_mask, graph.edge_src, spread),
            torch.where(graph.edge_mask, graph.edge_dst, spread))


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
    """Dense layers ``l0 … l{n-1}`` (the reference's ``mlp_init`` keys),
    each computed in ``dtype`` (`Dense`)."""

    def __init__(self, dims: Sequence[int], *, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(a, b, device=device, dtype=dtype)
            for a, b in zip(dims[:-1], dims[1:]))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)


def reset_dense_layers(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every `Dense` weight of ``model`` from ``generator``, in module
    order."""
    for mod in model.modules():
        if isinstance(mod, Dense):
            mod.reset_parameters(generator)


def mlp_init(dims: Sequence[int], generator: torch.Generator, *,
             device=None) -> MLP:
    mlp = MLP(dims, device=device)
    mlp.reset_parameters(generator)
    return mlp


def mlp_apply(mlp: MLP, x: torch.Tensor, *, act: Callable = silu,
              final_act: bool = False) -> torch.Tensor:
    """The reference's ``mlp_apply``; each layer computes in its own
    dtype (`MLP`'s ``dtype``, the reference's ``dtype=`` argument)."""
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


def node_regression_loss(pred: torch.Tensor, targets: torch.Tensor,
                         node_mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid nodes of the squared error averaged over outputs;
    (N,) targets broadcast onto (N, V) predictions."""
    targets = targets.float()
    if targets.dim() == pred.dim() - 1:
        targets = targets[..., None].expand(pred.shape)
    err = torch.square(pred.float() - targets)
    err = err.mean(dim=-1) * node_mask
    return err.sum() / node_mask.sum().clamp(min=1)


def graph_regression_loss(pred: torch.Tensor, targets: torch.Tensor
                          ) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - targets.float()))
