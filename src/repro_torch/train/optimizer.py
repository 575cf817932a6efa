"""AdamW with a linear-warmup cosine schedule (``repro.train.optimizer``
on PyTorch).

The reference's arithmetic, step for step: the schedule and the bias
corrections ``1 − b1^step`` and ``1 − b2^step`` are computed in f32 from
the f32 step, grads are clipped by their global norm before the moments,
the moments are dense and take each parameter's dtype, and every parameter
decays (norm scales and embeddings included).  DLRM's tables therefore
get a dense update every step, as in the reference: there is no sparse
Adam.

Params are trees of tensors (nested dicts, lists and tuples, as
``train.checkpoint`` flattens them), for example ``dict(
model.named_parameters())``.  `adamw_update` writes the new parameters
and moments into the given tensors, in place, and returns them: the
reference returns new arrays, and in place the trainer needs no second
copy of a 1.7 B-parameter model; the step counter too is incremented in
place, last, so a caller can tell whether an update ran.  Each leaf's
update is ``kernels.adamw``: on the card one launch of the fused kernel
(f32 leaves), on the CPU its plain version in slices of
``kernels.adamw.ops.CHUNK`` elements so that the f32 temporaries stay
small (`global_norm` squares the leaves in the same slices); both compute the reference's
per-element f32 operations in its order.  `zero1_specs` waits for the
port's sharding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from ..kernels.adamw.ops import adamw_leaf, slices
from .checkpoint import tree_flatten, tree_unflatten

__all__ = ["AdamWState", "AdamWConfig", "schedule", "adamw_init",
           "global_norm", "adamw_update"]

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), f32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Params) -> AdamWState:
    """Zero moments shaped and typed like ``params``, step 0 (int32, on the
    first leaf's device)."""
    leaves, treedef = tree_flatten(params)
    device = leaves[0].device if leaves else None
    zeros = [torch.zeros_like(p, memory_format=torch.contiguous_format)
             for p in leaves]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_unflatten(treedef, zeros),
        nu=tree_unflatten(treedef, [torch.zeros_like(z) for z in zeros]))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), each leaf squared in f32."""
    total = None
    for g in tree_flatten(tree)[0]:
        s = None
        for part in slices(g.contiguous()):
            ps = torch.sum(torch.square(part.to(torch.float32)))
            s = ps if s is None else s + ps
        if s is None:
            continue
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamWState,
                 params: Params) -> Tuple[Params, AdamWState]:
    """One AdamW step: writes the new parameters into ``params``, the new
    moments into ``state``'s tensors and step + 1 into ``state.step``;
    returns (params, state)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    step32 = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** step32
    b2c = 1 - cfg.b2 ** step32

    scalars = torch.stack([scale, lr, b1c, b2c]).to(torch.float32)
    p_leaves, treedef = tree_flatten(params)
    g_leaves = tree_flatten(grads)[0]
    m_leaves = tree_flatten(state.mu)[0]
    v_leaves = tree_flatten(state.nu)[0]
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("params, grads and moments must have the same leaves")
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("adamw_update writes in place: parameters and "
                             "moments must be contiguous")
        adamw_leaf(p, g, m, v, scalars, cfg)
    state.step.copy_(step)
    return params, state
