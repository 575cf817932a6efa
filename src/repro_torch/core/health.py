"""Run-health report — the fault-tolerance layer's audit trail.

Every recovery the runtime performs silently *changes what happened*
without changing the mined result: a checkpoint restore that fell back
across the COMMIT chain, a transient-EIO save that succeeded on retry, an
overflowed pattern re-run at base cap, a distributed level degraded to the
batched plane.  `RunHealth` is the single place those events land, so a
caller can distinguish "clean run" from "run that recovered" — the results
are bit-identical either way (that is the point), but an operator watching
a mining service needs to see the difference.

The report is carried in `MiningResult.health` and serialized into the
launcher's ``--json`` output.  It is deliberately *excluded* from the
resume bit-identity contract: an interrupted-and-resumed run records the
recoveries it performed; the uninterrupted oracle records none.

Event kinds currently emitted (see docs/architecture.md "Fault
tolerance"):

  * ``save_retry``          — transient I/O error during a snapshot write,
                              retried with backoff and eventually succeeded
  * ``save_async_failure``  — a background checkpoint write died; the error
                              was surfaced (re-raised) to the caller
  * ``restore_fallback``    — the newest snapshot was corrupt/unreadable;
                              restore fell back to an older committed step
  * ``checksum_mismatch``   — a stored array failed its manifest CRC
  * ``overflow_escalation`` — patterns that overflowed an auto-derived cap
                              were re-run at the base cap (exactness pass)
  * ``plane_fallback``      — a distributed level failed and was re-run on
                              the batched plane
  * ``preempted``           — the run was stopped by request after cutting
                              a final committed snapshot
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

__all__ = ["HealthEvent", "RunHealth"]


@dataclasses.dataclass
class HealthEvent:
    """One recovery/degradation/retry, with enough context to act on."""

    kind: str
    detail: str = ""
    step: Optional[int] = None      # checkpoint step, for persistence events
    level: Optional[int] = None     # mining level, for execution events

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "detail": self.detail}
        if self.step is not None:
            d["step"] = int(self.step)
        if self.level is not None:
            d["level"] = int(self.level)
        return d


@dataclasses.dataclass
class RunHealth:
    """Append-only log of every recovery a run performed."""

    events: List[HealthEvent] = dataclasses.field(default_factory=list)

    def record(self, kind: str, detail: str = "", *,
               step: Optional[int] = None,
               level: Optional[int] = None) -> HealthEvent:
        ev = HealthEvent(kind=kind, detail=detail, step=step, level=level)
        self.events.append(ev)
        return ev

    def count(self, kind: str) -> int:
        return sum(1 for ev in self.events if ev.kind == kind)

    @property
    def degraded(self) -> bool:
        """True when anything at all had to be recovered/retried."""
        return bool(self.events)

    def to_dict(self) -> Dict[str, Any]:
        """The ``--json`` schema: events in order plus per-kind counts."""
        counts: Dict[str, int] = {}
        for ev in self.events:
            counts[ev.kind] = counts.get(ev.kind, 0) + 1
        return {
            "degraded": self.degraded,
            "counts": counts,
            "events": [ev.to_dict() for ev in self.events],
        }
