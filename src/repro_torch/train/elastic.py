"""Elastic scaling and failure handling for the host training loop
(``repro.train.elastic`` on PyTorch).

  * Checkpoints hold whole logical leaves whatever the mesh, so recovery
    after losing ranks is: build the largest feasible mesh from the
    survivors (`best_mesh`), then ``restore(..., shardings=new)`` — no
    format change (`resume_or_init`).

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
from typing import Optional, Tuple

from ..launch.mesh import make_mesh_for_devices, world_size
from . import checkpoint as ckpt

__all__ = ["best_mesh_shape", "best_mesh", "StragglerTimeout", "StepGuard",
           "uninterruptible", "HeartbeatFile", "resume_or_init"]


def best_mesh_shape(n_devices: int, *, prefer_model: int = 16
                    ) -> Tuple[int, int]:
    """(data, model) of the largest mesh over ``n_devices`` ranks: the
    model axis is the largest power of two that divides n and is at most
    ``prefer_model``, data gets the rest."""
    model = 1
    while model * 2 <= prefer_model and n_devices % (model * 2) == 0:
        model *= 2
    return n_devices // model, model


def best_mesh(n_devices: Optional[int] = None, *, prefer_model: int = 16,
              device_type=None):
    """The `best_mesh_shape` ``("data", "model")`` mesh over the process
    group's ranks (``n_devices`` defaults to the world size and must
    equal it)."""
    n = n_devices if n_devices is not None else world_size()
    _, model = best_mesh_shape(n, prefer_model=prefer_model)
    return make_mesh_for_devices(n, model, device_type=device_type)


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


def resume_or_init(ckpt_dir, init_fn, tree_like, shardings=None,
                   device=None):
    """Restore the latest committed checkpoint onto ``device`` (each leaf
    cut to this rank's shard by ``shardings``, possibly another mesh than
    the writer's), or initialize fresh.  Returns (state, extra,
    start_step)."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return init_fn(), {}, 0
    state, extra, step = ckpt.restore(ckpt_dir, tree_like, step=step,
                                      device=device, shardings=shardings)
    return state, extra, step + 1
