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
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from .elastic import uninterruptible
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["trainable_params", "init_opt_state", "make_train_step"]


def trainable_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters that take gradients, by module name."""
    return {name: p for name, p in model.named_parameters()
            if p.requires_grad}


def init_opt_state(model: nn.Module) -> AdamWState:
    return adamw_init(trainable_params(model))


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig) -> Callable:
    """``step(model, opt_state, *batch) → (loss, model, opt_state)``: the
    loss of ``loss_fn(model, *batch)`` (detached, f32), then AdamW on its
    gradients; the model's parameters and the state's moments are
    updated in place."""

    def step(model: nn.Module, opt_state: AdamWState, *batch):
        params = trainable_params(model)
        if not params:
            raise ValueError("the model has no trainable parameter: build it "
                             "with train=True")
        loss = loss_fn(model, *batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    materialize_grads=True)
        with uninterruptible():
            _, opt_state = adamw_update(opt_cfg, dict(zip(params, grads)),
                                        opt_state, params)
        return loss.detach(), model, opt_state

    return step
