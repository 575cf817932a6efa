"""Gradient compression for the data-parallel all-reduce
(``repro.train.compression`` on PyTorch).

int8 quantize → all-reduce → dequantize, with per-tensor scales kept f32:
``scale = max|g|/127 + 1e-12``, ``q = clip(round(g/scale), −127, 127)``
(round half to even) as int8.  Error feedback (a residual carried from
step to step) keeps the quantization noise unbiased.  Trees are nested
dicts, lists and tuples of tensors (``train.checkpoint.tree_flatten``).

The reference's trainer does not call it, and neither does the port's:
it is ported as the function it is.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .checkpoint import tree_flatten, tree_unflatten

__all__ = ["CompressionState", "compression_init", "compress_tree",
           "decompress_tree", "compressed_psum"]

Params = Any


class CompressionState(NamedTuple):
    residual: Params  # error-feedback accumulator


def _map(fn, *trees):
    leaves, treedef = tree_flatten(trees[0])
    others = [tree_flatten(t)[0] for t in trees[1:]]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def compression_init(grads: Params) -> CompressionState:
    return CompressionState(residual=_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Params, state: Optional[CompressionState] = None):
    """→ (quantized tree, scales tree, new residual state)."""
    if state is not None:
        grads = _map(lambda g, r: g.to(torch.float32) + r, grads,
                     state.residual)
    leaves, treedef = tree_flatten(grads)
    qs = [_quantize(g) for g in leaves]
    q_tree = tree_unflatten(treedef, [q for q, _ in qs])
    s_tree = tree_unflatten(treedef, [s for _, s in qs])
    if state is not None:
        state = CompressionState(residual=_map(
            lambda g, q, s: g - _dequantize(q, s), grads, q_tree, s_tree))
    return q_tree, s_tree, state


def decompress_tree(q_tree: Params, s_tree: Params) -> Params:
    return _map(_dequantize, q_tree, s_tree)


def compressed_psum(grads: Params, group=None,
                    state: Optional[CompressionState] = None):
    """The int8 all-reduce of a gradient tree over ``group`` (the default
    group when None; without a process group, a group of one): the int8
    payloads summed in int32 (no overflow for ≤ 2^23 ranks), the scales
    averaged — an unbiased mean-of-quantized estimate — and the sum
    divided by the group's size.  → (tree, state)."""
    q, s, state = compress_tree(grads, state)
    n = dist.get_world_size(group) if dist.is_initialized() else 1

    def reduce(t: torch.Tensor) -> torch.Tensor:
        if n > 1:
            dist.all_reduce(t, group=group)
        return t

    q_sum = _map(lambda x: reduce(x.to(torch.int32)), q)
    s_mean = _map(lambda x: reduce(x.clone()) / n, s)
    out = _map(lambda qq, ss: qq.to(torch.float32) * ss / n, q_sum, s_mean)
    return out, state
