"""What a mining session's snapshots cost: bytes, seconds, kinds.

`SnapshotMeter` is a context manager that wraps `MiningSession._save`
(the mining thread's time per snapshot: encode, drain of the previous
write, then ``save`` or the host copies of ``save_async``) and
`train.checkpoint._save_once` (the write itself, on whichever thread runs
it: seconds and the bytes of the committed step directory).  Used by
``chip_smoke.py`` and ``scripts/torch_session_cost.py``; nothing in the
package imports it.
"""
from __future__ import annotations

import statistics
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional
from unittest import mock

from ..runtime import session as session_lib
from ..train import checkpoint as ckpt

__all__ = ["SnapshotMeter"]


class SnapshotMeter:
    """Collects one record per snapshot while active.

    ``snapshots``: per `_save` call — ``level``, ``kind`` ("boundary",
    "batched" for an in-flight group, "sampled" for a sample-phase cursor,
    "level" for a cursor between groups), ``mining_s`` (time the mining
    thread spent in it).  ``writes``: per committed write — ``step``,
    ``bytes`` on disk, ``write_s``.  ``updates``: carried-state updates
    (the points a cadence of 1 snapshots at) by level.  With ``live`` each
    record is printed as it lands.
    """

    def __init__(self, live: bool = False, prefix: str = "[snapshot]"):
        self.snapshots: List[dict] = []
        self.writes: List[dict] = []
        self.updates: Dict[int, int] = {}
        self._live = live
        self._prefix = prefix
        self._lock = threading.Lock()
        self._patches: list = []

    def __enter__(self) -> "SnapshotMeter":
        save = session_lib.MiningSession._save
        on_update = session_lib.MiningSession._on_state_update
        save_once = ckpt._save_once
        meter = self

        def counted_update(sess):
            level = sess._recorder.level
            with meter._lock:
                meter.updates[level] = meter.updates.get(level, 0) + 1
            on_update(sess)

        def timed_save(sess, state):
            cur = state.cursor
            kind = ("boundary" if cur is None
                    else "batched" if cur.inflight_group is not None
                    else "sampled" if cur.sampled is not None else "level")
            level = state.loop.level if cur is None else cur.level
            t0 = time.perf_counter()
            try:
                save(sess, state)
            finally:
                meter._record("snapshots", {
                    "step": sess._step, "level": level, "kind": kind,
                    "mining_s": time.perf_counter() - t0})

        def timed_save_once(root, step, tree, **kw):
            t0 = time.perf_counter()
            final = save_once(root, step, tree, **kw)
            dt = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in Path(final).iterdir())
            meter._record("writes", {"step": step, "bytes": nbytes,
                                     "write_s": dt})
            return final

        self._patches = [
            mock.patch.object(session_lib.MiningSession, "_save", timed_save),
            mock.patch.object(session_lib.MiningSession, "_on_state_update",
                              counted_update),
            mock.patch.object(ckpt, "_save_once", timed_save_once),
        ]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc) -> None:
        for p in reversed(self._patches):
            p.stop()

    def _record(self, where: str, rec: dict) -> None:
        with self._lock:
            getattr(self, where).append(rec)
        if self._live:
            print(f"{self._prefix} {where[:-1]} {rec}", flush=True)

    def summary(self, level: Optional[int] = None) -> dict:
        """Counts, bytes per snapshot (median, max, total) and seconds
        (mining thread, writes), over every snapshot or one ``level``."""
        snaps = [s for s in self.snapshots if level in (None, s["level"])]
        steps = {s["step"] for s in snaps}
        writes = [w for w in self.writes if w["step"] in steps]
        sizes = [w["bytes"] for w in writes] or [0]
        return {
            "updates": (sum(self.updates.values()) if level is None
                        else self.updates.get(level, 0)),
            "snapshots": len(snaps),
            "bytes_median": int(statistics.median(sizes)),
            "bytes_max": int(max(sizes)),
            "bytes_total": int(sum(sizes)),
            "mining_s": sum(s["mining_s"] for s in snaps),
            "write_s": sum(w["write_s"] for w in writes),
            "by_kind": {k: sum(1 for s in snaps if s["kind"] == k)
                        for k in ("boundary", "batched", "sampled",
                                  "level")},
        }
