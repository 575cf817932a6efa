"""Public wrapper: drop-in replacement for the single-phase level pipeline.

``core/matcher._expand_level`` sends every CUDA frontier here.  A CUDA
frontier launches the kernel
(``kernel.py``); a CPU frontier takes the plain version (``ref.py``); any
other device raises.  There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import torch

from .kernel import frontier_expand
from .ref import frontier_expand_ref


def plan_rows(plans, level: int) -> torch.Tensor:
    """(P, 5 + 2k) int32 rows of the plan fields the kernel reads at ``level``."""
    i = level
    cols = [plans.anchor_pos[:, i:i + 1], plans.anchor_out[:, i:i + 1],
            plans.cand_label[:, i:i + 1], plans.min_out[:, i:i + 1],
            plans.min_in[:, i:i + 1], plans.check_out[:, i], plans.check_in[:, i]]
    return torch.cat([c.to(torch.int32) for c in cols], 1).contiguous()


def frontier_expand_level(g, plans, emb, count, level: int, cfg):
    """Same signature/result as the single-phase ``_expand_level``, with the
    per-level ``found > cap`` overflow flag.

    g: DeviceGraph; plans: stacked PatternPlan (leading P); emb (P, cap, k)
    int32; count (P,) int32.  Returns (out_emb (P, cap, k) int32,
    out_count (P,) int32, found (P,) int32, ovf (P,) bool).
    """
    if emb.device.type == "cpu":
        return frontier_expand_ref(g, plans, emb, count, level, cfg)
    if emb.device.type != "cuda":
        raise ValueError(f"frontier_expand_level: no kernel for {emb.device}")
    return frontier_expand(
        g.labels, g.out_indptr, g.out_indices, g.in_indptr, g.in_indices,
        emb.contiguous(), count.contiguous(), plan_rows(plans, level),
        level=level, chunk=cfg.chunk, max_chunks=cfg.max_chunks,
        bisect_iters=cfg.bisect_iters)
