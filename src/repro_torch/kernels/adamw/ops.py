"""Public wrapper: the AdamW update of one parameter.

``train/optimizer.adamw_update`` sends every leaf here.  A CUDA tensor
launches the fused kernel (``kernel.py``); a CPU tensor takes the plain
version (``ref.py``) in `slices` of `CHUNK` elements, so that its f32
temporaries stay small (the arithmetic is elementwise: slicing changes no
value); any other device raises.  There is no fallback from the kernel to
the plain version.
"""
from __future__ import annotations

import torch

from .kernel import adamw_fused
from .ref import adamw_ref


CHUNK = 1 << 26   # elements of a leaf updated at once on the CPU (256 MB of f32)


def slices(t: torch.Tensor):
    """Flat views of ``t`` (contiguous), `CHUNK` elements each."""
    flat = t.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        yield flat[lo:lo + CHUNK]


def adamw_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scalars: torch.Tensor, cfg) -> None:
    """Write the AdamW step of p (and of its moments m, v) in place;
    ``scalars`` (4,) f32 on p's device: clip scale, lr, 1 − b1^t,
    1 − b2^t."""
    if p.device.type == "cuda":
        adamw_fused(p, g.contiguous(), m, v, scalars, cfg)
        return
    if p.device.type != "cpu":
        raise ValueError(f"adamw: no kernel for {p.device}")
    for ps, gs, ms, vs in zip(slices(p), slices(g.contiguous()), slices(m),
                              slices(v)):
        adamw_ref(ps, gs, ms, vs, scalars, cfg)
