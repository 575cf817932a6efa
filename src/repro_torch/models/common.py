"""Shared model building blocks — ``repro.models.common`` on PyTorch.

Layers are ``nn.Module``s holding their weights; the ``*_apply`` functions
keep the reference's arithmetic exactly:

  * a dense layer casts x and W to bf16 at the boundary and returns bf16;
    its weight is stored as ``nn.Linear`` does, ``(out, in)``, already in
    bf16 (every use casts to bf16 first, and f32 → bf16 rounds to nearest
    even in both frameworks, so storing the rounded value changes nothing);
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

__all__ = ["Dense", "RMSNorm", "dense_apply", "rmsnorm_apply", "embed_apply",
           "rotary_embedding", "apply_rope", "softcap", "count_params",
           "normal_"]


def normal_(t: torch.Tensor, scale: float, generator: torch.Generator
            ) -> torch.Tensor:
    """Fill ``t`` with ``scale · N(0, 1)``, drawn in f32 and rounded to
    ``t``'s dtype (the reference draws f32 parameters)."""
    with torch.no_grad():
        draw = torch.randn(t.shape, generator=generator, device=t.device,
                           dtype=torch.float32)
        t.copy_(draw.mul_(scale))
    return t


class Dense(nn.Module):
    """``x @ W`` with W of shape (in, out) in the reference, stored here as
    ``weight`` (out, in) in bf16."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, device=device,
                                               dtype=torch.bfloat16),
                                   requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, 1.0 / math.sqrt(self.in_dim), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(self.weight, x)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device,
                                             dtype=torch.float32),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(self.scale, x)


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
    return table.to(dtype)[ids]


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


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
