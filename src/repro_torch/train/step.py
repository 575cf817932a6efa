"""One training step: loss, gradients and AdamW (the reference's
``value_and_grad`` + ``adamw_update`` step of every arch family).

The model is an ``nn.Module`` whose trainable parameters
(``requires_grad``) are the optimizer's tree, keyed by their module names
(`trainable_params`).  Gradients come from ``torch.autograd.grad``, so no
``.grad`` is kept between steps; a parameter the loss does not reach (the
last NequIP layer's vector and tensor weights) gets a zero gradient, as
``jax.grad`` gives it.  AdamW writes the new values into the
parameters in place, with the step guard's alarm held back
(`elastic.uninterruptible`): a step is cut before its update or after it,
never inside.

Under a mesh (a `MeshPlan`: the mesh, each parameter's partition spec and
each moment's) the model holds this rank's shards and the batch this
rank's rows.  The loss runs under the plan's rules
(``models.sharding.use_rules``); each gradient is summed over the mesh
axes its parameter's spec does not split (the data axes always, the
model axis for a replicated leaf: ``models.sharding``'s convention); the
update runs on the local shards through the AdamW kernel, the moments
split again over the data axes where the plan says so (ZeRO-1: each data
rank updates its slice, then the slices are gathered back into the
parameter); and the loss returned is the sum of the ranks' shares over
the data axes, the global batch's.  On a 1×1 mesh every collective is
skipped and the step is the unsharded one, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..models.sharding import (NamedSharding, PartitionSpec, _all_reduce_raw,
                               _axes_of, _axis_size, use_rules)
from .elastic import uninterruptible
from .optimizer import (AdamWConfig, AdamWState, _zero1_dim, adamw_init,
                        adamw_update, zero1_specs)

__all__ = ["trainable_params", "init_opt_state", "make_train_step",
           "MeshPlan"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How a model's training state lies over ``mesh``: ``params`` and
    ``moments`` map each parameter's name to its partition spec and to
    its moments' (mesh axis names)."""
    mesh: Any
    params: Dict[str, PartitionSpec]
    moments: Dict[str, PartitionSpec]

    @classmethod
    def for_arch(cls, arch, mesh, *, reduced: bool = False) -> "MeshPlan":
        """The arch's ``param_pspecs``, and its moments split further by
        `zero1_specs` over the mesh's data axes."""
        params = arch.param_pspecs(reduced=reduced)
        data = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        return cls(mesh, params, zero1_specs(
            params, arch.abstract_params(reduced=reduced), data, mesh))

    def sharding(self, name: str, moment: bool = False) -> NamedSharding:
        return NamedSharding(self.mesh, (self.moments if moment
                                         else self.params)[name])

    def _axes(self) -> tuple:
        return tuple(a for a in self.mesh.mesh_dim_names
                     if _axis_size(self.mesh, a) > 1)

    def sum_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum each gradient, in place, over the mesh axes its parameter's
        spec does not split."""
        for name, g in grads.items():
            used = {a for part in self.params[name] for a in _axes_of(part)}
            for a in self._axes():
                if a not in used:
                    g.copy_(_all_reduce_raw(g, self.mesh, a))

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        for a in ("pod", "data"):
            if a in self.mesh.mesh_dim_names:
                t = _all_reduce_raw(t, self.mesh, a)
        return t

    def local_moment_shape(self, name: str, local_param_shape) -> tuple:
        """A moment's shape on this rank, from its parameter's shard."""
        shape = list(local_param_shape)
        split = _zero1_dim(self.params[name], self.moments[name])
        if split is not None:
            shape[split[0]] //= _axis_size(self.mesh, split[1])
        return tuple(shape)


def trainable_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters that take gradients, by module name."""
    return {name: p for name, p in model.named_parameters()
            if p.requires_grad}


def init_opt_state(model: nn.Module, plan: Optional[MeshPlan] = None
                   ) -> AdamWState:
    """Zero moments for the model's (local) parameters; under ``plan``
    shaped by its moment specs."""
    params = trainable_params(model)
    if plan is None:
        return adamw_init(params)

    def zeros():
        return {n: torch.zeros(plan.local_moment_shape(n, p.shape),
                               dtype=p.dtype, device=p.device)
                for n, p in params.items()}

    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)
    return AdamWState(step=step, mu=zeros(), nu=zeros())


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    plan: Optional[MeshPlan] = None) -> Callable:
    """``step(model, opt_state, *batch) → (loss, model, opt_state)``: the
    loss of ``loss_fn(model, *batch)`` (detached, f32), then AdamW on its
    gradients; the model's parameters and the state's moments are
    updated in place.  Under ``plan``, the sharded step (module doc)."""

    def step(model: nn.Module, opt_state: AdamWState, *batch):
        params = trainable_params(model)
        if not params:
            raise ValueError("the model has no trainable parameter: build it "
                             "with train=True")
        if plan is None:
            loss = loss_fn(model, *batch)
        else:
            with use_rules(plan.mesh):
                loss = loss_fn(model, *batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), materialize_grads=True)))
        if plan is not None:
            plan.sum_grads(grads)
        with uninterruptible():
            _, opt_state = adamw_update(opt_cfg, grads, opt_state, params,
                                        plan=plan)
        loss = loss.detach()
        return (loss if plan is None else plan.sum_over_data(loss)), model, \
            opt_state

    return step
