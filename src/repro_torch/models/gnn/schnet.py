"""SchNet (Schütt et al., arXiv:1706.08566), continuous-filter
convolutions (``repro.models.gnn.schnet`` on PyTorch).

Interaction block: ``W·h_j ⊙ filter(RBF(‖r_i − r_j‖))`` summed over
neighbours, with shifted-softplus activations.  The reference's
arithmetic step for step: bf16 dense layers, the RBF and the cosine
envelope computed in f32 and cast to bf16 before the filter, the
envelope applied to the filter's output (edges past the cutoff contribute
exactly zero), the messages summed by ``scatter_sum`` in bf16.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..common import Dense, for_serving
from .common import (
    MLP, GraphBatch, gather, graph_regression_loss, mlp_apply,
    node_regression_loss, reset_dense_layers, scatter_sum, segment_pool,
    spread_padding,
)

__all__ = ["SchNetConfig", "SchNet", "ssp", "rbf_expand", "schnet_init",
           "schnet_apply", "schnet_loss"]


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    d_in: int
    d_hidden: int = 64
    n_interactions: int = 3
    n_rbf: int = 300
    cutoff: float = 10.0
    graph_level: bool = True
    n_out: int = 1


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus as the reference computes it: the softplus in x's
    dtype, each step rounded as ``jnp.logaddexp(x, 0)`` rounds it
    (``max(x, 0) + log1p(exp(−|x|))``), then ``− np.log(2.0)``, a float64
    numpy scalar that JAX does not take as weakly typed: the result is f32
    (the next dense layer rounds it to bf16)."""
    sp = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return sp.float() - math.log(2.0)


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)``: ``start·(1 − s) +
    stop·s`` with ``s = i / (num − 1)`` in f32, the last point ``stop``
    (``torch.linspace`` differs by an ulp at some points)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    head = start * (1 - step) + stop * step
    return torch.cat([head, torch.full((1,), stop, dtype=torch.float32,
                                       device=device)])


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """(E,) distances → (E, n_rbf) Gaussian radial basis, in f32."""
    centers = _linspace(0.0, cutoff, n_rbf, dist.device)
    gamma = torch.tensor(10.0 * n_rbf / cutoff ** 2, dtype=torch.float32,
                         device=dist.device) / n_rbf
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


class Interaction(nn.Module):
    """One interaction block: ``filter`` (an MLP on the RBF), ``in_proj``,
    ``out1``, ``out2``."""

    def __init__(self, cfg: SchNetConfig, *, device=None):
        super().__init__()
        H = cfg.d_hidden
        self.filter = MLP((cfg.n_rbf, H, H), device=device)
        self.in_proj = Dense(H, H, device=device)
        self.out1 = Dense(H, H, device=device)
        self.out2 = Dense(H, H, device=device)


class SchNet(nn.Module):
    """``embed``, ``int{i}`` and the ``head`` MLP, the reference's names."""

    def __init__(self, cfg: SchNetConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Dense(cfg.d_in, cfg.d_hidden, device=device)
        for i in range(cfg.n_interactions):
            self.add_module(f"int{i}", Interaction(cfg, device=device))
        self.head = MLP((cfg.d_hidden, cfg.d_hidden // 2, cfg.n_out),
                        device=device)

    def interactions(self):
        return [getattr(self, f"int{i}")
                for i in range(self.cfg.n_interactions)]


def schnet_init(cfg: SchNetConfig, generator: torch.Generator, *,
                device=None, train: bool = False) -> SchNet:
    """Random weights from ``generator``: f32 trainable masters with
    ``train``, else `for_serving`."""
    model = SchNet(cfg, device=device)
    reset_dense_layers(model, generator)
    return model if train else for_serving(model)


def schnet_apply(model: SchNet, gb: GraphBatch) -> torch.Tensor:
    cfg = model.cfg
    if gb.pos is None:
        raise ValueError("SchNet needs positions (GraphBatch.pos)")
    n = gb.x.shape[0]
    bf16 = torch.bfloat16
    h = model.embed(gb.x.to(bf16))
    src, dst = spread_padding(gb)
    rij = gather(gb.pos, src) - gather(gb.pos, dst)
    dist = torch.linalg.vector_norm(rij.float() + 1e-12, dim=-1)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff).to(bf16)
    # smooth cosine cutoff on the filter's output (SchNetPack's form)
    env = (0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                  + 1.0) * (dist < cfg.cutoff)).to(bf16)
    for ip in model.interactions():
        w = mlp_apply(ip.filter, rbf, act=ssp) * env[:, None]      # (E, H)
        msg = gather(ip.in_proj(h), src) * w
        agg = scatter_sum(msg, dst, gb.edge_mask, n)
        h = h + ip.out2(ssp(ip.out1(agg)))
    out = mlp_apply(model.head, h, act=ssp)
    if cfg.graph_level:
        return segment_pool(out, gb.graph_ids, gb.node_mask, gb.n_graphs,
                            mean=False)
    return out


def schnet_loss(model: SchNet, gb: GraphBatch) -> torch.Tensor:
    out = schnet_apply(model, gb)
    if model.cfg.graph_level:
        return graph_regression_loss(out[:, 0], gb.targets)
    return node_regression_loss(out, gb.targets, gb.node_mask)
