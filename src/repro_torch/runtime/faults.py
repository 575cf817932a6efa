"""Deterministic fault injection for the mining runtime.

The fault-tolerance layer (checksummed checkpoints, COMMIT-chain fallback,
save retries) is only as trustworthy as the failures it was tested against.
This module makes those failures *reproducible*: a seeded `FaultPlan`
holds a list of `FaultSpec`s, each naming an **injection point** the
runtime fires on its hot path, the arrival index at which to trigger, and
the fault class to inject.  The tests enumerate the fault × point matrix
and assert every cell completes with results identical to the fault-free
oracle.

Injection points (fired via the module-level `fire`; zero work when no
plan is installed):

  * ``save.io``           — start of every checkpoint write attempt
                            (inside the retry loop: transient-I/O class)
  * ``save.array_write``  — after each array file lands in the tmp dir
                            (``path`` = the file: torn-write class)
  * ``save.manifest``     — after the manifest lands in the tmp dir
                            (``path`` = the file: corruption class)
  * ``save.pre_commit``   — after the tmp→final rename, before COMMIT
                            (crash-inside-save class)
  * ``save.committed``    — after COMMIT (``path`` = the step dir:
                            post-hoc bit-rot class)
  * ``session.snapshot``  — after a session snapshot is fully persisted
                            (kill-at-snapshot class)
  * ``level.distributed`` — entry of the distributed level executor
                            (mesh-failure class; nothing in this package
                            fires it until the distributed plane exists)

Fault kinds:

  * ``crash``            — raise `InjectedCrash` (stands in for SIGKILL;
                           a *BaseException* so no recovery path may
                           swallow it — only the injecting test catches it)
  * ``io_error``         — raise ``OSError(errno)`` (default ``EIO``;
                           transient when fired fewer times than the
                           save retry budget)
  * ``error``            — raise `InjectedFault` (a plain RuntimeError:
                           the recoverable-failure class)
  * ``torn_write``       — truncate the file at ``path`` to half its
                           bytes, then raise `InjectedCrash`
  * ``bitflip``          — flip one seeded bit of one seeded ``arr_*.npy``
                           under ``path`` (no raise — silent bit-rot)
  * ``corrupt_manifest`` — overwrite the file at ``path`` with truncated
                           garbage (no raise)

Plans come from code (`install`) or from the ``REPRO_TORCH_FAULT_PLAN``
env var (JSON, see `FaultPlan.from_env`) so subprocess runs can be
injected without touching the command line.
"""
from __future__ import annotations

import dataclasses
import errno as errno_lib
import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "FAULT_PLAN_ENV", "FaultSpec", "FaultPlan", "InjectedCrash",
    "InjectedFault", "install", "clear", "active", "fire", "POINTS", "KINDS",
]

FAULT_PLAN_ENV = "REPRO_TORCH_FAULT_PLAN"

POINTS = (
    "save.io", "save.array_write", "save.manifest", "save.pre_commit",
    "save.committed", "session.snapshot", "level.distributed",
)
KINDS = ("crash", "io_error", "error", "torn_write", "bitflip",
         "corrupt_manifest")


class InjectedCrash(BaseException):
    """An injected hard kill.  Deliberately NOT an `Exception`: recovery
    code catching ``Exception`` must treat this like SIGKILL (i.e. not at
    all) — only the fault-matrix test that injects it catches it."""


class InjectedFault(RuntimeError):
    """An injected recoverable failure (the ``error`` kind)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: fire ``kind`` at arrivals [at, at+times) of ``point``."""

    point: str
    kind: str
    at: int = 1          # 1-based arrival index of the first firing
    times: int = 1       # consecutive arrivals that fire
    errno_name: str = "EIO"   # io_error kind only: EIO / ENOSPC / ...

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown injection point {self.point!r}; "
                             f"must be one of {POINTS}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"must be one of {KINDS}")
        if self.at < 1 or self.times < 1:
            raise ValueError("at and times must be >= 1")
        if not hasattr(errno_lib, self.errno_name):
            raise ValueError(f"unknown errno {self.errno_name!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"point": self.point, "kind": self.kind, "at": self.at,
                "times": self.times, "errno": self.errno_name}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(point=str(d["point"]), kind=str(d["kind"]),
                   at=int(d.get("at", 1)), times=int(d.get("times", 1)),
                   errno_name=str(d.get("errno", "EIO")))


class FaultPlan:
    """A seeded set of `FaultSpec`s with per-point arrival counters.

    Thread-safe: checkpoint writes may fire points from a background
    thread.  ``hits`` counts arrivals per point; ``fired`` logs every
    fault actually injected (the tests assert against it).
    """

    def __init__(self, specs: List[FaultSpec], *, seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self.hits: Dict[str, int] = {}
        self.fired: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        """Parse ``REPRO_TORCH_FAULT_PLAN`` — either a JSON list of spec
        dicts or ``{"seed": int, "faults": [...]}``.  None when unset."""
        raw = (environ if environ is not None else os.environ).get(
            FAULT_PLAN_ENV)
        if not raw:
            return None
        d = json.loads(raw)
        if isinstance(d, list):
            d = {"faults": d}
        specs = [FaultSpec.from_dict(s) for s in d.get("faults", [])]
        return cls(specs, seed=int(d.get("seed", 0)))

    # -- firing -------------------------------------------------------------
    def fire(self, point: str, *, path=None, step: Optional[int] = None
             ) -> None:
        with self._lock:
            n = self.hits.get(point, 0) + 1
            self.hits[point] = n
            due = [s for s in self.specs
                   if s.point == point and s.at <= n < s.at + s.times]
            for s in due:
                self.fired.append({**s.to_dict(), "arrival": n,
                                   "step": step})
        for s in due:
            self._act(s, n, path=path, step=step)

    def _act(self, spec: FaultSpec, arrival: int, *, path, step) -> None:
        where = f"{spec.point} (arrival {arrival}, step {step})"
        if spec.kind == "crash":
            raise InjectedCrash(f"injected crash at {where}")
        if spec.kind == "io_error":
            err = getattr(errno_lib, spec.errno_name)
            raise OSError(err, f"injected {spec.errno_name} at {where}")
        if spec.kind == "error":
            raise InjectedFault(f"injected failure at {where}")
        if spec.kind == "torn_write":
            f = Path(path)
            data = f.read_bytes()
            f.write_bytes(data[: len(data) // 2])
            raise InjectedCrash(f"injected torn write at {where} ({f.name})")
        if spec.kind == "bitflip":
            root = Path(path)
            files = (sorted(root.glob("arr_*.npy")) if root.is_dir()
                     else [root])
            # flip a payload bit, not the .npy header — header damage is
            # caught by np.load itself; the CRC must catch *silent* rot
            # (so prefer files that carry payload past the 128-byte header)
            payload = [f for f in files if f.stat().st_size > 128]
            files = payload or files
            rng = np.random.default_rng(self.seed * 1_000_003 + arrival)
            f = files[int(rng.integers(len(files)))]
            data = bytearray(f.read_bytes())
            lo = min(128, len(data) - 1)
            pos = int(rng.integers(lo, len(data)))
            data[pos] ^= 1 << int(rng.integers(8))
            f.write_bytes(bytes(data))
            return
        if spec.kind == "corrupt_manifest":
            Path(path).write_text('{"format_version": 2, "truncat')
            return
        raise AssertionError(f"unhandled fault kind {spec.kind}")


# -- process-wide installed plan --------------------------------------------
_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False
_LOCK = threading.Lock()


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide (None uninstalls).  Returns it."""
    global _PLAN, _ENV_CHECKED
    with _LOCK:
        _PLAN = plan
        _ENV_CHECKED = True   # an explicit install overrides the env
    return plan


def clear() -> None:
    """Remove any installed plan and re-arm env-var pickup."""
    global _PLAN, _ENV_CHECKED
    with _LOCK:
        _PLAN = None
        _ENV_CHECKED = False


def active() -> Optional[FaultPlan]:
    """The installed plan, lazily picking up ``REPRO_TORCH_FAULT_PLAN``."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is None and not _ENV_CHECKED:
        with _LOCK:
            if _PLAN is None and not _ENV_CHECKED:
                _PLAN = FaultPlan.from_env()
                _ENV_CHECKED = True
    return _PLAN


def fire(point: str, *, path=None, step: Optional[int] = None) -> None:
    """Fire an injection point.  No-op (one None check) without a plan."""
    plan = active()
    if plan is not None:
        plan.fire(point, path=path, step=step)
