"""Execution planner — the forced planes' pass-through and the block schedule.

The reference's ``ExecutionPlanner`` answers three questions per level (data
plane, bucket width, matcher geometry) from a calibrated cost model when
``execution="auto"``.  This port carries the part the forced planes use:

  * ``execution="batched"`` / ``"sequential"`` pass through unchanged — the
    level runs the config's plane and geometry verbatim;
  * the static **degree-ordered root-block schedule** (`root_block_order`),
    which every plane walks.  It fixes mIS priority (embedding-row order
    along the schedule), so it matches the reference bit for bit.

``"auto"``, ``"sampled"`` and ``"distributed"`` need the cost model and the
sampled/distributed planes (ROADMAP Queue 1 items 8, 9 and 11); asking for
them raises ``NotImplementedError``.  No calibration file is read or written.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .graph import DataGraph
from .matcher import MatchConfig

__all__ = ["LevelPlan", "ExecutionPlanner", "block_degree_stat",
           "root_block_order", "UNPORTED_PLANES"]

# planes of the reference that need modules this port does not have yet
UNPORTED_PLANES = {
    "auto": "ROADMAP Queue 1 item 8 (core/planner.py cost model)",
    "sampled": "ROADMAP Queue 1 item 9 (core/sampled.py)",
    "distributed": "ROADMAP Queue 1 item 11 (core/distributed.py)",
}


def block_degree_stat(g: DataGraph, root_block: int) -> np.ndarray:
    """Per-root-block max out-degree (block-id indexed, int64 ≥ −1)."""
    n_blocks = max(1, -(-g.n // root_block))
    deg = np.diff(g.out_indptr).astype(np.int64)
    padded = np.full(n_blocks * root_block, -1, np.int64)
    padded[: deg.shape[0]] = deg
    return padded.reshape(n_blocks, root_block).max(axis=1)


def root_block_order(g: DataGraph, root_block: int,
                     mode: str = "degree") -> np.ndarray:
    """Static permutation of root-block ids — the level's block schedule.

    ``"degree"``: blocks sorted by descending max out-degree of their
    vertices (stable, so ties keep vertex-id order) — high-yield roots run
    first and τ early-exit terminates levels sooner.  ``"vertex"``: the
    identity order.
    """
    n_blocks = max(1, -(-g.n // root_block))
    if mode == "vertex" or n_blocks == 1:
        return np.arange(n_blocks, dtype=np.int64)
    if mode != "degree":
        raise ValueError('root_order must be "degree" or "vertex"')
    block_max = block_degree_stat(g, root_block)
    # stable descending sort: ties stay in ascending block-id order
    return np.argsort(-block_max, kind="stable").astype(np.int64)


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One level's execution decision."""

    plane: str                 # "sequential" | "batched"
    match: MatchConfig         # per-level matcher geometry
    max_batch: int             # pattern-bucket ceiling for level_groups


class ExecutionPlanner:
    """Per-level (plane, bucket, geometry) for ``mine()`` — forced planes only."""

    def __init__(self, g: DataGraph, cfg):
        if cfg.execution in UNPORTED_PLANES:
            raise NotImplementedError(
                f"execution={cfg.execution!r} is not ported yet: "
                f"{UNPORTED_PLANES[cfg.execution]}")
        self.g = g
        self.cfg = cfg
        self.block_order = root_block_order(
            g, cfg.match.root_block, getattr(cfg, "root_order", "degree"))
        self.n_blocks = int(self.block_order.shape[0])

    def plan_level(self, level: int, patterns: Sequence, taus: Sequence[int],
                   prev: Optional[Dict[str, Any]] = None) -> LevelPlan:
        """Forced execution modes return the config's plane/geometry verbatim."""
        cfg = self.cfg
        return LevelPlan(plane=cfg.execution, match=cfg.match,
                         max_batch=cfg.batch_patterns)
