"""Plain torch version of the AdamW kernel (the oracle), the reference's
per-element arithmetic (``repro.train.optimizer.adamw_update``'s ``upd``):
f32, each operation rounded, in this order.  ``scalars`` holds (clip
scale, lr, 1 − b1^t, 1 − b2^t) as f32 tensors; the parameter and the
moments are written in place."""
from __future__ import annotations

import torch


@torch.no_grad()
def adamw_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, scalars, cfg) -> None:
    scale, lr, b1c, b2c = scalars
    g32 = g.to(torch.float32) * scale
    m_new = cfg.b1 * m + (1 - cfg.b1) * g32
    v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    mh = m_new / b1c
    vh = v_new / b2c
    p32 = p.to(torch.float32)
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
    p.copy_(p32 - lr * delta)
    m.copy_(m_new)
    v.copy_(v_new)
