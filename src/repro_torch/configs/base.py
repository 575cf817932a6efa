"""What the port's arch wrappers share (``repro.configs.base``): the shape
cell, and a tensor spec in place of JAX's ``ShapeDtypeStruct``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

__all__ = ["ShapeCell", "TensorSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # train | prefill | decode | serve | retrieval
    meta: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
