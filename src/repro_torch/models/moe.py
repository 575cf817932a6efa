"""Mixture-of-Experts FFN — ``repro.models.moe`` on PyTorch.

The reference's per-row, sort-based dispatch, step by step: every batch
row routes its own S·top_k assignments (f32 router, softmax, top-k with
the lower expert first on ties, renormalised gates), sorts them by expert
(stable), keeps the first ``C = capacity(cfg, S)`` of each expert and
drops the rest.  The slot tables ``tok_of_slot`` / ``gate_of_slot``
(``E·C`` slots a row, sentinel token S for an empty slot) feed a gather of
the tokens, the SwiGLU experts as batched products over the stacked
``(E, D, F)`` weights, and the combine.

The combine adds each token's kept contributions in increasing slot
order, rounding in ``x``'s dtype after each add, as the reference's
``.at[...].add`` does: a gather of the token's (at most top_k) slots,
sorted, then a fixed sequence of adds.  A scatter-add on the card would
add with atomics in an order that changes from run to run, and in bf16
another order moves outputs by more than rounding.  Everything else is
a gather, a sort or a scatter to distinct slots, so a second call gives
the same bytes.

Under a mesh the experts are split over the model axis (the reference's
EP rule): every rank gathers the sequence, routes the whole rows (the
router is replicated), runs its own experts' slots and adds their
contributions; the partial sums are reduce-scattered onto the sequence.
The aux loss's statistics are summed over the data ranks, so that it is
the global batch's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .common import RESIDUAL, normal_, silu
from .sharding import (axis_index, constrain, current_mesh, extent,
                       psum_logical)

__all__ = ["MoEConfig", "capacity", "MoE", "Route"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k gates (Mixtral-style)


def capacity(cfg: MoEConfig, tokens_per_row: int) -> int:
    c = int(np.ceil(tokens_per_row * cfg.top_k * cfg.capacity_factor
                    / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # multiple of 8, as the reference's


class Route(NamedTuple):
    """One forward's routing (B rows of S tokens, E experts, C slots an
    expert): integer fields are exact outputs, compared with the
    reference's as such."""
    probs: torch.Tensor         # (B, S, E) f32 router softmax
    gate: torch.Tensor          # (B, S, K) f32, renormalised
    idx: torch.Tensor           # (B, S, K) int64 experts, best first
    counts: torch.Tensor        # (B, E) assignments routed to each expert
    tok_of_slot: torch.Tensor   # (B, E·C) token of each slot, S if empty
    gate_of_slot: torch.Tensor  # (B, E·C) f32 gate, 0 if empty
    slots: torch.Tensor         # (B, S, K) each token's slots, increasing;
                                # a dropped assignment has slot E·C


class MoE(nn.Module):
    """``router`` (D, E), the reference's kernel layout, f32 always (the
    routing is computed in f32 and no serving rounding applies to it);
    ``wi``, ``wg`` (E, D, F) and ``wo`` (E, F, D) in f32, rounded to
    ``dtype`` once `for_serving` (each use casts them to x's dtype)."""

    def __init__(self, cfg: MoEConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.serve_dtype = {"wi": dtype, "wg": dtype, "wo": dtype}

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=torch.float32))

        self.router = param(D, E)
        self.wi, self.wg, self.wo = param(E, D, F), param(E, D, F), \
            param(E, F, D)
        # assignments the last forward dropped (0-d, on x's device)
        self.last_dropped = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init``: router N(0, 1/D), wi and wg
        N(0, 1/D), wo N(0, 1/F)."""
        D, F = self.cfg.d_model, self.cfg.d_ff
        normal_(self.router, 1.0 / math.sqrt(D), generator)
        normal_(self.wi, 1.0 / math.sqrt(D), generator)
        normal_(self.wg, 1.0 / math.sqrt(D), generator)
        normal_(self.wo, 1.0 / math.sqrt(F), generator)

    def route(self, x: torch.Tensor) -> Route:
        """The routing and the per-row dispatch plan of x (B, S, D)."""
        cfg = self.cfg
        B, S, _ = x.shape
        K, E = cfg.top_k, cfg.n_experts
        C = capacity(cfg, S)
        SK = S * K
        dev = x.device

        logits = x.float() @ self.router.float()
        probs = torch.softmax(logits, dim=-1)                 # (B, S, E)
        # lax.top_k: the K largest, the lower index first on ties
        gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, idx = gate[..., :K], idx[..., :K]
        if cfg.router_norm_topk:
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

        fe = idx.reshape(B, SK)
        fg = gate.reshape(B, SK)
        ftok = (torch.arange(SK, device=dev) // K).expand(B, SK)
        order = torch.argsort(fe, dim=1, stable=True)
        se = torch.gather(fe, 1, order)
        st = torch.gather(ftok, 1, order)
        sg = torch.gather(fg, 1, order)
        counts = torch.zeros((B, E), dtype=torch.long, device=dev
                             ).scatter_add_(1, fe, torch.ones_like(fe))
        starts = torch.cumsum(counts, dim=1) - counts
        rank = torch.arange(SK, device=dev)[None] - torch.gather(starts, 1, se)
        keep = rank < C
        slot = torch.where(keep, se * C + rank, E * C)        # drop column
        tok_of_slot = torch.full((B, E * C + 1), S, dtype=torch.long,
                                 device=dev).scatter(1, slot, st)[:, :E * C]
        gate_of_slot = torch.zeros((B, E * C + 1), dtype=fg.dtype, device=dev
                                   ).scatter(1, slot, sg)[:, :E * C]
        # back to each token's own assignments, its slots in increasing order
        slots = torch.empty_like(slot).scatter_(1, order, slot)
        slots = torch.sort(slots.reshape(B, S, K), dim=-1).values
        return Route(probs, gate, idx, counts, tok_of_slot, gate_of_slot,
                     slots)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, D) → (y, aux_loss).  SwiGLU experts."""
        cfg = self.cfg
        x = constrain(x, "batch", "seq", "embed", src=RESIDUAL)
        B, S, D = x.shape
        K, E = cfg.top_k, cfg.n_experts
        C = capacity(cfg, S)
        dt = x.dtype
        r = self.route(x)
        filled = (r.tok_of_slot < S)[..., None]               # (B, E·C, 1)

        # gather-dispatch → expert FFN → weighted combine
        src = torch.clamp(r.tok_of_slot, max=S - 1)[..., None].expand(
            B, E * C, D)
        xe = torch.gather(x, 1, src)
        xe = torch.where(filled, xe, torch.zeros((), dtype=dt, device=x.device)
                         ).reshape(B, E, C, D)
        # this rank's experts (all of them without a mesh)
        xe = constrain(xe, "batch", "expert", None, None,
                       src=("batch", None, None, None))
        El = xe.shape[1]
        first = 0 if El == E else axis_index(current_mesh(), "model") * El
        h = torch.einsum("becd,edf->becf", xe, self.wi.to(dt))
        g = torch.einsum("becd,edf->becf", xe, self.wg.to(dt))
        ye = torch.einsum("becf,efd->becd", silu(g) * h, self.wo.to(dt))
        ye = constrain(ye, "batch", "expert", None, None)
        lo, hi = first * C, (first + El) * C
        contrib = (ye.reshape(B, El * C, D)
                   * r.gate_of_slot[:, lo:hi, None].to(dt)
                   * filled[:, lo:hi].to(dt))
        # row El·C of the padded table is zero: a dropped assignment (or
        # another rank's expert) adds 0
        contrib = torch.cat([contrib, contrib.new_zeros(B, 1, D)], dim=1)
        slots = r.slots
        if El != E:
            # this rank's experts' part, added in f32: the ranks' parts are
            # summed in f32 and rounded once
            slots = torch.where((slots >= lo) & (slots < hi), slots - lo,
                                El * C)
            contrib = contrib.float()
        y = torch.zeros((B, S, D), dtype=contrib.dtype, device=x.device)
        for k in range(K):
            at = slots[:, :, k, None].expand(B, S, D)
            y = y + torch.gather(contrib, 1, at)
        y = constrain(y, *RESIDUAL, partial="model").to(dt)

        # Switch-style load-balancing aux loss, over the global batch
        n_data = extent("batch")
        if n_data == 1:
            me = r.probs.mean(dim=(0, 1))                     # (E,)
            counts = r.counts.sum(0)
        else:
            me = psum_logical(r.probs.sum(dim=(0, 1)), "batch") / (
                B * S * n_data)
            counts = psum_logical(r.counts.sum(0), "batch")
        fe_frac = counts.float() / (B * S * K * n_data)
        aux = E * torch.sum(me * fe_frac)
        self.last_dropped = B * S * K - filled.sum()
        return y, aux
