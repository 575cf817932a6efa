"""Public wrapper: the embedding bag for one table or a stack of them.

``models/embedding`` sends every lookup here.  A CUDA tensor launches the
kernel (``kernel.py``); a CPU tensor takes the plain version (``ref.py``),
which autograd differentiates; any other device raises.  There is no
fallback from the kernel to the plain version.

Under autograd (grad mode on and the tables requiring a gradient) a CUDA
call goes through `EmbeddingBag`, a ``torch.autograd.Function`` whose
backward is the backward kernel: `bag_grad_plan` sorts the valid ids by
(table, row) on the card with a stable sort, so each row's entries form
one segment in ascending (bag, slot) order, and the kernel reduces each
segment in that order (deterministic, no atomics).  Per-id weights take
no gradient: weights that require one raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .kernel import embedding_bag_bwd_tbh, embedding_bag_tbh
from .ref import embedding_bag_ref

COMBINERS = ("sum", "mean")


@dataclasses.dataclass(frozen=True)
class BagGradPlan:
    """The backward's segments.  entry (n,) int32: the flat (b, t, h)
    indices of the n valid ids, sorted by key t·R + id (stable); seg_start
    (n_seg + 1,) int32 cuts ``entry`` into one segment a key; seg_row
    (n_seg,) int64: each segment's key, the flat row of the (T·R, D)
    gradient; coef (B·T·H,) f32: each entry's factor, its weight (1 without)
    divided by its bag's count of valid ids for the mean; H: ids a bag."""

    entry: torch.Tensor
    seg_start: torch.Tensor
    seg_row: torch.Tensor
    coef: torch.Tensor
    H: int


def bag_grad_plan(ids: torch.Tensor, weights: Optional[torch.Tensor], R: int,
                  mean: bool) -> BagGradPlan:
    """The segments of the tables' gradient for ids (B, T, H), on ids'
    device.  Ids outside [0, R) belong to no segment."""
    B, T, H = ids.shape
    dev = ids.device
    valid = (ids >= 0) & (ids < R)
    t_idx = torch.arange(T, device=dev, dtype=torch.int64)[None, :, None]
    key = torch.where(valid, t_idx * R + ids.long(),
                      torch.full_like(t_idx, T * R))
    sorted_key, order = torch.sort(key.reshape(-1), stable=True)
    n = int(valid.sum())
    sorted_key = sorted_key[:n]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = sorted_key[1:] != sorted_key[:-1]
    starts = torch.nonzero(new).reshape(-1)
    seg_start = torch.cat([starts, torch.full((1,), n, device=dev,
                                              dtype=starts.dtype)])
    coef = (torch.ones((B, T, H), dtype=torch.float32, device=dev)
            if weights is None else weights.to(torch.float32))
    if mean:
        coef = coef / valid.sum(dim=2, keepdim=True).clamp(min=1)
    return BagGradPlan(entry=order[:n].to(torch.int32),
                       seg_start=seg_start.to(torch.int32),
                       seg_row=sorted_key[starts].contiguous(),
                       coef=coef.reshape(-1).contiguous(), H=H)


class EmbeddingBag(torch.autograd.Function):
    """The bag kernel on CUDA tables with the backward kernel."""

    @staticmethod
    def forward(ctx, tables, ids, weights, mean):
        out = embedding_bag_tbh(tables, ids, weights, mean=mean)
        ctx.save_for_backward(ids, weights)
        ctx.mean = mean
        ctx.table_shape = tuple(tables.shape)
        return out

    @staticmethod
    def backward(ctx, d_out):
        ids, weights = ctx.saved_tensors
        T, R, _ = ctx.table_shape
        plan = bag_grad_plan(ids, weights, R, ctx.mean)
        d_tables = embedding_bag_bwd_tbh(d_out.contiguous(), plan, T, R)
        return d_tables, None, None, None


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  combiner: str = "sum") -> torch.Tensor:
    """tables (R, D) with ids (B, H) → (B, D), as the reference's
    ``ops.embedding_bag``; or tables (T, R, D) with ids (B, T, H) →
    (B, T, D), every table in one launch.  Pad ids are −1; weights have
    the ids' shape; the result has the tables' dtype."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    if weights is not None and weights.requires_grad and \
            torch.is_grad_enabled():
        raise ValueError("embedding_bag: weights take no gradient here; "
                         "detach them")
    single = tables.dim() == 2
    if single:
        tables, ids = tables[None], ids[:, None]
        weights = None if weights is None else weights[:, None]
    mean = combiner == "mean"
    if tables.device.type == "cpu":
        out = embedding_bag_ref(tables, ids, weights, mean=mean)
    elif tables.device.type == "cuda":
        if weights is not None:
            weights = weights.to(tables.dtype).contiguous()
        ids = ids.to(torch.int32).contiguous()
        if torch.is_grad_enabled() and tables.requires_grad:
            out = EmbeddingBag.apply(tables.contiguous(), ids, weights, mean)
        else:
            out = embedding_bag_tbh(tables.contiguous(), ids, weights,
                                    mean=mean)
    else:
        raise ValueError(f"embedding_bag: no kernel for {tables.device}")
    return out[:, 0] if single else out
