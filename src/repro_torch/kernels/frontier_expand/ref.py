"""Plain version of the frontier-expansion kernel = the torch pipeline.

The reference is the single-phase expansion
``repro_torch.core.matcher._expand_level_torch`` (``two_phase=False``).  The
kernel is bit-identical to it, including the (chunk, row, position)
survivor order the greedy-mIS metric depends on.
"""
from __future__ import annotations

from ...core.matcher import MatchConfig, _expand_level_torch


def frontier_expand_ref(g, plans, emb, count, level: int, cfg: MatchConfig):
    """Single-phase torch expansion of one level; same returns as the kernel:
    (out_emb (P, cap, k) int32, out_count (P,), found (P,), overflowed (P,)).

    The pipeline leaves the found > cap check to ``match_block``; the kernel
    flags it per level, so the ref does too (``match_block`` ORs the same
    check back in, so its results are identical either way).
    """
    out_emb, out_count, found, ovf = _expand_level_torch(
        g, plans, emb, count, level, cfg, two_phase=False)
    return out_emb, out_count, found, ovf | (found > cfg.cap)
