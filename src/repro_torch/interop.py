"""Converters for the state the port shares with the reference.

Numpy in, numpy out: nothing here imports JAX or ``repro``.  A test hands
the reference's arrays (``np.asarray`` of them) to these functions and
compares the port's outputs through them, one function per state type:

  * graphs — `data_graph_from_arrays` rebuilds a `DataGraph` from any object
    with the reference's `DataGraph` attributes;
  * plans — `plan_from_numpy` (from the reference plan's fields);
  * mIS bitmaps — `bitmap_from_uint32` / `bitmap_to_uint32`: the
    reference's ``(⌈n/32⌉,)`` uint32 words ↔ the port's int32 words, the
    same bits;
  * MNI / frac tables — `table_from_numpy` / `table_to_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.graph import DataGraph
from .core.plan import _TENSOR_FIELDS, PatternPlan, plan_from_numpy

__all__ = ["data_graph_from_arrays", "plan_from_numpy", "plan_from_fields",
           "bitmap_from_uint32", "bitmap_to_uint32", "table_from_numpy",
           "table_to_numpy"]


def data_graph_from_arrays(g) -> DataGraph:
    """A `DataGraph` with the same arrays as ``g`` (any object with the
    reference's `DataGraph` attributes)."""
    return DataGraph(
        n=int(g.n), labels=np.asarray(g.labels, np.int32),
        out_indptr=np.asarray(g.out_indptr, np.int64),
        out_indices=np.asarray(g.out_indices, np.int32),
        in_indptr=np.asarray(g.in_indptr, np.int64),
        in_indices=np.asarray(g.in_indices, np.int32),
        edge_keys=np.asarray(g.edge_keys, np.int64),
        n_labels=int(g.n_labels), undirected=bool(g.undirected))


def plan_from_fields(plan, device="cpu") -> PatternPlan:
    """A port plan from any object with the reference plan's fields (each
    converted with ``np.asarray``)."""
    return plan_from_numpy(plan.k, {f: np.asarray(getattr(plan, f))
                                    for f in _TENSOR_FIELDS},
                           order=getattr(plan, "order", ()), device=device)


def bitmap_from_uint32(words, device="cpu") -> torch.Tensor:
    """uint32 bitmap words (any leading shape) → int32 tensor, same bits."""
    a = np.ascontiguousarray(np.asarray(words, np.uint32))
    return torch.as_tensor(a.view(np.int32).copy()).to(device)


def bitmap_to_uint32(t: torch.Tensor) -> np.ndarray:
    """int32 bitmap tensor → uint32 numpy words, same bits."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def table_from_numpy(a, device="cpu") -> torch.Tensor:
    """MNI (bool) or frac (float32) table → tensor of the same dtype."""
    return torch.as_tensor(np.array(a)).to(device)


def table_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
