"""GraphCast-style encoder-processor-decoder mesh GNN (arXiv:2212.12794)
(``repro.models.gnn.graphcast`` on PyTorch).

Node and edge MLP encoders into ``d_hidden``, ``n_layers`` processor
blocks of edge update → sum aggregate → node update (interaction networks
with residuals), an MLP decoder back to ``n_vars`` outputs; every dense
layer in bf16.  The edges' 4-d input features are synthetic, as in the
reference: a constant, the source's and destination's in-degree / 16 and
the edge mask, with the degrees accumulated in bf16 (`scatter_sum` on the
card adds them with atomics; bf16 holds every integer up to 256 only).

Each processor block is one recomputation unit, as the reference wraps
it in ``jax.checkpoint``: under grad (`common.remat`, the policy from
``REPRO_REMAT_POLICY``, ``full`` by default) the backward recomputes a
block's edge activations — ``(E, 3·H)`` concatenations and ``(E, H)``
states — from its inputs instead of holding every layer's.  On the CPU the
recomputation repeats the first forward's bytes, so gradients equal those
without it; on the card the aggregate's bf16 ``index_add_`` adds with
atomics in no fixed order, so the recomputed states may differ from the
first forward's in low bits.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..common import for_serving, remat
from .common import (
    MLP, GraphBatch, gather, mlp_apply, reset_dense_layers, scatter_sum,
    spread_padding,
)

__all__ = ["GraphCastConfig", "GraphCast", "graphcast_init",
           "graphcast_apply"]


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    d_in: int
    d_hidden: int = 512
    n_layers: int = 16
    n_vars: int = 227
    mesh_refinement: int = 6


class Processor(nn.Module):
    """One processor block: the ``edge`` and ``node`` update MLPs."""

    def __init__(self, H: int, *, device=None):
        super().__init__()
        self.edge = MLP((3 * H, H, H), device=device)
        self.node = MLP((2 * H, H, H), device=device)


class GraphCast(nn.Module):
    """``enc_node``, ``enc_edge``, ``proc{i}`` and ``dec``, the reference's
    names."""

    def __init__(self, cfg: GraphCastConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.d_hidden
        self.enc_node = MLP((cfg.d_in, H, H), device=device)
        self.enc_edge = MLP((4, H, H), device=device)
        for i in range(cfg.n_layers):
            self.add_module(f"proc{i}", Processor(H, device=device))
        self.dec = MLP((H, H, cfg.n_vars), device=device)

    def processors(self):
        return [getattr(self, f"proc{i}") for i in range(self.cfg.n_layers)]


def graphcast_init(cfg: GraphCastConfig, generator: torch.Generator, *,
                   device=None, train: bool = False) -> GraphCast:
    """Random weights from ``generator``: f32 trainable masters with
    ``train``, else `for_serving`."""
    model = GraphCast(cfg, device=device)
    reset_dense_layers(model, generator)
    return model if train else for_serving(model)


def graphcast_apply(model: GraphCast, gb: GraphBatch) -> torch.Tensor:
    N = gb.x.shape[0]
    bf16 = torch.bfloat16
    h = mlp_apply(model.enc_node, gb.x.to(bf16))
    src, dst = spread_padding(gb)
    mask = gb.edge_mask.to(bf16)
    deg = torch.zeros((N,), dtype=bf16, device=gb.x.device).index_add_(
        0, dst, mask)
    ef = torch.stack([torch.ones_like(mask), gather(deg, src) / 16.0,
                      gather(deg, dst) / 16.0, mask], dim=-1)
    e = mlp_apply(model.enc_edge, ef)

    def processor(lp, h, e):
        # edge update: e' = MLP(e ⊕ h_src ⊕ h_dst) + e
        e = e + mlp_apply(lp.edge, torch.cat(
            [e, gather(h, src), gather(h, dst)], dim=-1))
        # node update: h' = MLP(h ⊕ Σ_in e') + h
        agg = scatter_sum(e, dst, gb.edge_mask, N)
        return h + mlp_apply(lp.node, torch.cat([h, agg], dim=-1)), e

    for lp in model.processors():
        h, e = remat(processor, lp, h, e)
    return mlp_apply(model.dec, h)
