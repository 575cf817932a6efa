"""What the port's arch wrappers share (``repro.configs.base``): the shape
cell, a tensor spec in place of JAX's ``ShapeDtypeStruct``, and the
partition-spec helpers.

A port model's parameters are keyed by module name and stored ``(out,
in)``; the reference's are a pytree of stacked ``(in, out)`` kernels.  The
spec rules are the reference's, written against its paths and layout, so
`model_pspecs` evaluates a rule on each parameter's reference entry
(``interop.param_entries``) and maps the result into the port's layout
(``interop.spec_to_port``): one source of truth for both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..interop import param_entries, spec_to_port
from ..models.sharding import P, PartitionSpec

__all__ = ["ShapeCell", "TensorSpec", "spec_tree_like", "model_pspecs",
           "abstract_params", "default_param_pspecs", "default_input_pspecs"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # train | prefill | decode | serve | retrieval
    meta: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def spec_tree_like(tree, fn: Callable[[Tuple, Any], PartitionSpec]):
    """Map (path, leaf) → PartitionSpec over a tree of dicts, lists and
    tuples (the path holds the keys and indices as strings); None stays
    None."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (str(i),)) for i, v in enumerate(t))
        return None if t is None else fn(path, t)
    return walk(tree, ())


def abstract_params(model: torch.nn.Module) -> Dict[str, TensorSpec]:
    """{parameter name: shape and dtype} of a model (built on the meta
    device by the arch wrappers: nothing is allocated)."""
    return {name: TensorSpec(tuple(p.shape), p.dtype)
            for name, p in model.named_parameters()}


def model_pspecs(model: torch.nn.Module, rule: Callable
                 ) -> Dict[str, PartitionSpec]:
    """{parameter name: spec in the port's layout}: ``rule(path, leaf)``,
    the reference's, on each parameter's reference path and leaf shape."""
    shapes = abstract_params(model)
    out = {}
    for entry in param_entries(model):
        name, path, step, transposed = entry
        shape = shapes[name].shape
        if name == "tables":                  # one (R, D) table of the stack
            shape = shape[1:]
        if transposed:
            shape = shape[::-1]
        if step is not None:                  # the stacked layer axis
            shape = (1,) + shape
        out[name] = spec_to_port(rule(path, TensorSpec(shape, torch.float32)), entry)
    return out


def default_param_pspecs(model: torch.nn.Module) -> Dict[str, PartitionSpec]:
    """Every parameter replicated (the reference's ``Arch.param_pspecs``)."""
    return {name: P() for name, _ in model.named_parameters()}


def default_input_pspecs(input_specs):
    """Every input replicated (the reference's ``Arch.input_pspecs``)."""
    return spec_tree_like(input_specs, lambda path, leaf: P())
