"""Failure handling for the host training loop (``repro.train.elastic`` on
PyTorch; its mesh helper ``best_mesh`` comes with the port's sharding).

  * The step loop runs under `StepGuard`: a wall-clock budget per step; a
    straggling or hung step raises `StragglerTimeout` so that the runner
    can checkpoint and restart.
  * `uninterruptible` holds the guard back over a block: the port updates
    parameters in place, so an update is all or nothing.  (Masking SIGALRM
    would not do: the kernel hands a process signal to any thread that
    does not mask it, and PyTorch's worker threads do not.)
  * `HeartbeatFile` is the liveness file a cluster agent watches (an
    mtime gone stale means kill and reschedule).
  * `resume_or_init` restores the latest committed checkpoint or starts
    fresh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import time
from pathlib import Path
from typing import Optional

from . import checkpoint as ckpt

__all__ = ["StragglerTimeout", "StepGuard", "uninterruptible",
           "HeartbeatFile", "resume_or_init"]


class StragglerTimeout(RuntimeError):
    pass


# the open `uninterruptible` blocks, and whether a guard fired inside one
_HOLD = {"depth": 0, "pending": False}


@dataclasses.dataclass
class StepGuard:
    """Raise StragglerTimeout if a step exceeds ``budget_s`` (SIGALRM-based;
    main thread only, which is where the host loop lives).  A budget of 0
    guards nothing."""

    budget_s: float

    def __enter__(self):
        if self.budget_s and hasattr(signal, "SIGALRM"):
            self._old = signal.signal(signal.SIGALRM, self._fire)
            signal.setitimer(signal.ITIMER_REAL, self.budget_s)
        return self

    @staticmethod
    def _fire(signum, frame):
        if _HOLD["depth"]:
            _HOLD["pending"] = True     # raised when the block ends
            return
        raise StragglerTimeout("step exceeded wall-clock budget")

    def __exit__(self, *exc):
        if self.budget_s and hasattr(signal, "SIGALRM"):
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, self._old)
        _HOLD["pending"] = False
        return False


@contextlib.contextmanager
def uninterruptible():
    """No `StepGuard` fires inside the block; a guard's timer that expires
    meanwhile raises its `StragglerTimeout` when the block ends."""
    _HOLD["depth"] += 1
    try:
        yield
    finally:
        _HOLD["depth"] -= 1
    if not _HOLD["depth"] and _HOLD["pending"]:
        _HOLD["pending"] = False
        raise StragglerTimeout("step exceeded wall-clock budget")


class HeartbeatFile:
    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int):
        self.path.write_text(f"{step} {time.time()}\n")

    def age_s(self) -> Optional[float]:
        if not self.path.exists():
            return None
        return time.time() - self.path.stat().st_mtime


def resume_or_init(ckpt_dir, init_fn, tree_like, device=None):
    """Restore the latest committed checkpoint onto ``device``, or
    initialize fresh.  Returns (state, extra, start_step)."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return init_fn(), {}, 0
    state, extra, step = ckpt.restore(ckpt_dir, tree_like, step=step,
                                      device=device)
    return state, extra, step + 1
