"""Shared model building blocks — ``repro.models.common`` on PyTorch.

Layers are ``nn.Module``s holding their weights; the ``*_apply`` functions
keep the reference's arithmetic exactly:

  * a dense layer casts x and W to bf16 at the boundary and returns bf16;
    its weight is stored as ``nn.Linear`` does, ``(out, in)``, as the
    reference's f32 master, which takes gradients and AdamW updates;
  * every layer is built so; `for_serving` then makes a built model a
    serving one: dense weights and embeddings rounded once to their
    compute dtype, every parameter frozen (every use casts to bf16 first,
    and f32 → bf16 rounds to nearest even in both frameworks, so storing
    the rounded value changes nothing);
  * RMSNorm scales by ``1 + scale``, in f32, and returns the input's dtype;
  * RoPE rotates split halves (``[x1·cos − x2·sin, x2·cos + x1·sin]``), not
    interleaved pairs;
  * the embedding table is cast to the compute dtype before the lookup (the
    transformer multiplies the result by ``sqrt(d_model)``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .sharding import constrain

# the residual stream's logical axes: under a mesh its sequence is split
# over the model axis (Megatron-SP)
RESIDUAL = ("batch", "residual", "embed")

__all__ = ["Dense", "RMSNorm", "for_serving", "round_for_serving",
           "RESIDUAL", "dense_apply", "row_parallel", "rmsnorm_apply",
           "embed_apply", "rotary_embedding", "apply_rope", "softcap", "silu",
           "count_params", "normal_"]


def normal_(t: torch.Tensor, scale: float, generator: torch.Generator
            ) -> torch.Tensor:
    """Fill ``t`` with ``scale · N(0, 1)``, drawn in f32 and rounded to
    ``t``'s dtype (the reference draws f32 parameters)."""
    with torch.no_grad():
        draw = torch.randn(t.shape, generator=generator, device=t.device,
                           dtype=torch.float32)
        t.copy_(draw.mul_(scale))
    return t


def round_for_serving(mod: nn.Module) -> None:
    """Round the parameters that ``mod`` itself names in its
    ``serve_dtype`` (not its children's) to that dtype, in place."""
    with torch.no_grad():
        for name, dtype in getattr(mod, "serve_dtype", {}).items():
            param = getattr(mod, name)
            param.data = param.data.to(dtype)


def for_serving(model: nn.Module) -> nn.Module:
    """Make a built model a serving one, in place, and return it: each
    parameter that a module names in its ``serve_dtype`` (dense weights,
    embeddings) is rounded to that dtype, and every parameter is frozen."""
    for mod in model.modules():
        round_for_serving(mod)
    for param in model.parameters():
        param.requires_grad_(False)
    return model


class Dense(nn.Module):
    """``x @ W`` with W of shape (in, out) in the reference, stored here as
    ``weight`` (out, in) in f32; computed in ``dtype`` (the reference's
    ``dense_apply(..., dtype=)``, bf16 by default), to which `for_serving`
    rounds the weight."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_dim, self.out_dim, self.dtype = in_dim, out_dim, dtype
        self.serve_dtype = {"weight": dtype}
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, device=device,
                                               dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, 1.0 / math.sqrt(self.in_dim), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(self.weight, x, dtype=self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device,
                                             dtype=torch.float32))

    def reset_parameters(self) -> None:
        """Scales 1, as built (for a module materialised by ``to_empty``)."""
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(self.scale, x)


def row_parallel(lin: Dense, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel dense layer (its weight's input columns split over
    the model axis) into the residual stream's layout.  Each rank's
    partial product is taken in f32 of the ``dtype``-rounded operands, the
    partial sums are reduce-scattered in f32 and rounded once, as the
    whole product rounds once; on a model axis of one (or no mesh) it is
    ``lin(x)``."""
    if lin.weight.shape[1] == lin.in_dim:
        return constrain(lin(x), *RESIDUAL, partial="model")
    y = F.linear(x.to(lin.dtype).float(), lin.weight.to(lin.dtype).float())
    return constrain(y, *RESIDUAL, partial="model").to(lin.dtype)


def dense_apply(weight: torch.Tensor, x: torch.Tensor, *,
                dtype=torch.bfloat16) -> torch.Tensor:
    """``x.astype(dtype) @ kernel.astype(dtype)`` with ``weight`` = kernelᵀ."""
    return F.linear(x.to(dtype), weight.to(dtype))


def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale)).to(x.dtype)


def embed_apply(table: torch.Tensor, ids: torch.Tensor, *,
                dtype=torch.bfloat16) -> torch.Tensor:
    """The rows of ``ids``; the reference's constrain to (batch, seq,
    embed) is the layout of ``ids`` (the rank's rows of the batch)."""
    return constrain(table.to(dtype)[ids], "batch", "seq", "embed")


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     base: float = 10000.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…,) positions → cos/sin tables of shape (…, head_dim/2), f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (float(base) ** exponent)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2).

    The products run in f32 (bf16 × f32 promotes, as in JAX) and the result
    is cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap), in f32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


class _SiLU(torch.autograd.Function):
    """``x · s`` with ``s = 1/(1 + e^−x)``; the gradient is the reference's
    (``logistic``'s own derivative ``s·(1 − s)``): autograd of the forward
    multiplies ``e^−x`` = inf by 0 below x ≈ −88 (f32; −89 in bf16) and
    returns NaN, where ``jax.grad`` of ``jax.nn.silu`` returns 0."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x · 1/(1 + e^−x)``
    in x's dtype, each step rounded (``F.silu`` rounds once, which moves a
    third of bf16 outputs by one unit in the last place); its gradient as
    ``jax.grad``'s (`_SiLU`)."""
    return _SiLU.apply(x)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
