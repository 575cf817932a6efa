"""NequIP-family E(3)-equivariant interatomic potential (arXiv:2101.03164)
(``repro.models.gnn.nequip`` on PyTorch).

The reference replaces e3nn's spherical-harmonic irreps by the equivalent
Cartesian ones up to l_max = 2: node state = (scalars s, vectors v,
traceless-symmetric rank-2 tensors t); messages combine neighbour
features with the edge harmonics Y0 = 1, Y1 = û, Y2 = ûûᵀ − I/3 through
every symmetry-allowed product path (`_PATHS`), each gated by a radial
MLP weight (Bessel basis, polynomial cutoff).  Every operation is
covariant, so E(3)-equivariance holds exactly.

Everything runs in f32, as in the reference (``dtype=f32`` on every dense
layer): the model's `Dense` layers carry f32 as their compute and serving
dtype, so `for_serving` leaves them f32.  Padded edges enter the gathers
(`spread_padding`) and are masked only at ``scatter_sum``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from ..common import Dense, for_serving, silu
from .common import (
    MLP, GraphBatch, gather, graph_regression_loss, mlp_apply,
    node_regression_loss, reset_dense_layers, scatter_sum, segment_pool,
    spread_padding,
)

__all__ = ["NequIPConfig", "NequIP", "bessel_basis", "nequip_init",
           "nequip_apply", "nequip_loss"]

# symmetry-allowed message paths (in_l, sh_l, out_l), Cartesian form
_PATHS = [
    ("s", 0, "s"), ("s", 1, "v"), ("s", 2, "t"),
    ("v", 0, "v"), ("v", 1, "s"), ("v", 1, "t"), ("v", 2, "v"),
    ("t", 0, "t"), ("t", 1, "v"), ("t", 2, "s"),
]
_PATH_INDEX = {f"{a}{l}{b}": i for i, (a, l, b) in enumerate(_PATHS)}

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    d_in: int
    d_hidden: int = 32          # channels per irrep order
    n_layers: int = 5
    n_rbf: int = 8
    cutoff: float = 5.0
    graph_level: bool = True


def bessel_basis(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """(E,) → (E, n_rbf) Bessel radial basis with a polynomial cutoff."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=F32, device=d.device)
    basis = (math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d[:, None]
                                                  / cutoff) / d[:, None])
    u = torch.clamp(d / cutoff, 0, 1)
    env = 1.0 - 10.0 * u ** 3 + 15.0 * u ** 4 - 6.0 * u ** 5   # p = 3
    return basis * env[:, None]


def _traceless(t: torch.Tensor) -> torch.Tensor:
    tr = torch.diagonal(t, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return 0.5 * (t + t.transpose(-1, -2)) - tr * eye / 3.0


class Layer(nn.Module):
    """One interaction layer: the ``radial`` MLP (one weight per path and
    channel) and the self-interaction and gate layers."""

    def __init__(self, cfg: NequIPConfig, *, device=None):
        super().__init__()
        C = cfg.d_hidden
        self.radial = MLP((cfg.n_rbf, 32, len(_PATHS) * C), device=device,
                          dtype=F32)
        for name in ("self_s", "self_v", "self_t", "gate_v", "gate_t"):
            self.add_module(name, Dense(C, C, device=device, dtype=F32))


class NequIP(nn.Module):
    """``embed``, ``layer{i}`` and the ``head`` MLP, the reference's
    names."""

    def __init__(self, cfg: NequIPConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.d_hidden
        self.embed = Dense(cfg.d_in, C, device=device, dtype=F32)
        for i in range(cfg.n_layers):
            self.add_module(f"layer{i}", Layer(cfg, device=device))
        self.head = MLP((C, C, 1), device=device, dtype=F32)

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.cfg.n_layers)]


def nequip_init(cfg: NequIPConfig, generator: torch.Generator, *,
                device=None, train: bool = False) -> NequIP:
    """Random weights from ``generator``: f32 trainable masters with
    ``train``, else frozen f32 serving weights (`for_serving`)."""
    model = NequIP(cfg, device=device)
    reset_dense_layers(model, generator)
    return model if train else for_serving(model)


def _messages(s_j, v_j, t_j, y1, y2, w
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-edge tensor-product messages.  Shapes: s_j (E,C); v_j (E,C,3);
    t_j (E,C,3,3); y1 (E,3); y2 (E,3,3); w (E,P,C)."""
    u1 = y1[:, None, :]                       # (E,1,3)
    u2 = y2[:, None, :, :]                    # (E,1,3,3)

    def W(a, l, b):
        return w[:, _PATH_INDEX[f"{a}{l}{b}"], :]

    m_s = (W("s", 0, "s") * s_j
           + W("v", 1, "s") * torch.einsum("ecx,ex->ec", v_j, y1)
           + W("t", 2, "s") * torch.einsum("ecxy,exy->ec", t_j, y2))
    m_v = (W("s", 1, "v")[..., None] * (s_j[..., None] * u1)
           + W("v", 0, "v")[..., None] * v_j
           + W("v", 2, "v")[..., None] * torch.einsum("ecx,exy->ecy", v_j, y2)
           + W("t", 1, "v")[..., None] * torch.einsum("ecxy,ey->ecx", t_j,
                                                      y1))
    m_t = (W("s", 2, "t")[..., None, None] * (s_j[..., None, None] * u2)
           + W("v", 1, "t")[..., None, None] * _traceless(
               torch.einsum("ecx,ey->ecxy", v_j, y1))
           + W("t", 0, "t")[..., None, None] * t_j)
    return m_s, m_v, m_t


def nequip_apply(model: NequIP, gb: GraphBatch) -> torch.Tensor:
    cfg = model.cfg
    if gb.pos is None:
        raise ValueError("NequIP needs positions (GraphBatch.pos)")
    N, C = gb.x.shape[0], cfg.d_hidden
    dev = gb.x.device
    s = model.embed(gb.x.float())                                  # (N,C)
    v = torch.zeros((N, C, 3), dtype=F32, device=dev)
    t = torch.zeros((N, C, 3, 3), dtype=F32, device=dev)

    src, dst = spread_padding(gb)
    rij = (gather(gb.pos, src) - gather(gb.pos, dst)).float()
    dist = torch.linalg.vector_norm(rij + 1e-12, dim=-1)
    y1 = rij / torch.clamp(dist, min=1e-6)[:, None]                 # (E,3)
    y2 = _traceless(torch.einsum("ex,ey->exy", y1, y1))             # (E,3,3)
    rbf = bessel_basis(dist, cfg.n_rbf, cfg.cutoff)

    em = gb.edge_mask
    for lp in model.layers():
        w = mlp_apply(lp.radial, rbf).reshape(-1, len(_PATHS), C)
        s_j, v_j, t_j = (gather(a, src) for a in (s, v, t))
        m_s, m_v, m_t = _messages(s_j, v_j, t_j, y1, y2, w)
        agg_s = scatter_sum(m_s, dst, em, N)
        agg_v = scatter_sum(m_v.reshape(-1, C * 3), dst, em,
                            N).reshape(N, C, 3)
        agg_t = scatter_sum(m_t.reshape(-1, C * 9), dst, em,
                            N).reshape(N, C, 3, 3)
        # self-interaction: channel mixing per irrep (equivariant: acts on
        # C); the weights are (out, in), the reference's kernels transposed
        s = s + torch.tanh(lp.self_s(agg_s))
        gate_v = torch.sigmoid(lp.gate_v(s))
        gate_t = torch.sigmoid(lp.gate_t(s))
        v = v + gate_v[..., None] * torch.einsum("ncx,dc->ndx", agg_v,
                                                 lp.self_v.weight)
        t = t + gate_t[..., None, None] * torch.einsum(
            "ncxy,dc->ndxy", agg_t, lp.self_t.weight)

    energy = mlp_apply(model.head, s, act=silu)          # (N,1)
    if cfg.graph_level:
        return segment_pool(energy, gb.graph_ids, gb.node_mask, gb.n_graphs,
                            mean=False)
    return energy


def nequip_loss(model: NequIP, gb: GraphBatch) -> torch.Tensor:
    out = nequip_apply(model, gb)
    if model.cfg.graph_level:
        return graph_regression_loss(out[:, 0], gb.targets)
    return node_regression_loss(out, gb.targets, gb.node_mask)
