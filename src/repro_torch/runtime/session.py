"""Checkpointed mining sessions — a preemption-safe `mine()` run.

A `MiningSession` wraps `repro_torch.core.flexis.mine` with the
level-boundary and mid-level hooks the core exposes, and persists the full
mining state through `repro_torch.train.checkpoint`'s atomic
manifest/COMMIT protocol:

  * at **every level boundary** the whole loop state (frontier, stats,
    candidates of the next level, τ/telemetry bookkeeping) is snapshotted;
  * **inside a level**, the carried state of the in-flight pattern group
    is snapshotted every ``checkpoint_every`` state updates — one update
    per root block of the batched plane, one per logical super-block of
    the distributed plane, one per completed sample group and one at
    classification on the sampled plane — so a kill mid-pattern loses at
    most ``checkpoint_every`` of them;
  * the metric state on the card (mIS bitmaps/counters, MNI/frac tables)
    is copied to host and saved as full arrays; a resume places it on the
    session's device again.

Resume contract: ``MiningSession(...).run()`` on a directory holding a
snapshot continues the run and returns a `MiningResult` identical to the
uninterrupted run's, except wall-clock fields (``elapsed_s``, per-level
``wall_s``).  A crash *during* a save never corrupts the previous
snapshot (`train/checkpoint.py`'s COMMIT guarantee), so the worst case is
re-doing work since the last committed snapshot — never wrong results.

Under a ``torch.distributed`` group every rank runs the session; rank 0
alone writes snapshots, and every rank restores the same one.  The
distributed plane's super-block schedule is pinned
(`DEFAULT_BLOCKS_PER_SUPER`) and its carried state is replicated, so a run
killed at one world size resumes at another to the same `MiningResult`
except ``wall_s`` and ``dispatches`` (launches are a property of the
mesh).  This is the reference's ``repro.runtime.session``.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..core import distributed as distributed_lib
from ..core.batched import GroupState, PatternOutcome
from ..core.distributed import SuperBlockState
from ..core.flexis import (
    MiningConfig, MiningLoopState, MiningResult, initial_candidates, mine,
)
from ..core.graph import DataGraph
from ..core.health import RunHealth
from ..device import resolve_device
from ..train import checkpoint as ckpt

from . import faults
from .state import (
    GroupDone, LevelCursor, SampledCursor, SessionState, encode_session,
)
from .resume import load_session, session_fingerprint

__all__ = ["MiningSession", "PreemptedError", "DEFAULT_BLOCKS_PER_SUPER"]

# distributed-plane sessions pin the logical super-block width so the
# schedule (and with it every accounting field) survives a change of world
# size; 8 root blocks keep up to 8 ranks busy a super-block while bounding
# the work a mid-super-block kill loses
DEFAULT_BLOCKS_PER_SUPER = 8


class PreemptedError(BaseException):
    """The session was asked to stop (`request_preempt`) and did so right
    after committing a snapshot — the run is consistent and resumable.

    A *BaseException* on purpose (like KeyboardInterrupt): no recovery
    path — save retry and the like — may swallow a preemption request;
    only the top-level caller (`launch/mine.py`) catches it.
    """


class _LevelRecorder:
    """Per-level hooks object handed to the level executors.

    Implements the duck-typed surface `evaluate_level_batched`,
    `evaluate_level_sampled` and `evaluate_level_distributed` document:
    replays completed groups from the resume cursor, hands the in-flight
    group its carried state, and records every state update back into the
    session for snapshotting.
    """

    def __init__(self, session: "MiningSession", level: int,
                 resume_cursor: Optional[LevelCursor]):
        self._session = session
        self.level = level
        self.groups_done: List[GroupDone] = (
            list(resume_cursor.groups_done) if resume_cursor else [])
        self._resume = resume_cursor
        self.inflight_key: Optional[Tuple[int, int]] = None
        self.inflight_group: Optional[GroupState] = None
        self.inflight_super: Optional[SuperBlockState] = None
        self.plan: Optional[dict] = (
            resume_cursor.plan if resume_cursor else None)
        self.sampled: Optional[SampledCursor] = (
            resume_cursor.sampled if resume_cursor else None)

    # -- resume side --------------------------------------------------------
    def resume_plan(self) -> Optional[dict]:
        """The planner decision recorded for this level, or None (fresh
        level / forced execution) — `mine()` replays it verbatim."""
        return self._resume.plan if self._resume is not None else None

    def resume_outcomes(self) -> Optional[Dict[int, PatternOutcome]]:
        if not self.groups_done:
            return None
        return {i: o for gd in self.groups_done
                for i, o in zip(gd.idxs, gd.outcomes)}

    def resume_dispatches(self) -> int:
        return sum(gd.dispatches for gd in self.groups_done)

    def resume_block_peaks(self):
        """Element-wise max of the completed groups' per-block peak
        telemetry (block-id indexed), or None when no group recorded it."""
        peaks = None
        for gd in self.groups_done:
            if gd.block_peaks is None:
                continue
            arr = list(gd.block_peaks)
            peaks = arr if peaks is None else [max(a, b) for a, b in
                                               zip(peaks, arr)]
        return peaks

    def resume_replans(self) -> int:
        """Total within-level cap replans of the completed groups."""
        return sum(gd.replans for gd in self.groups_done)

    def resume_sampled(self) -> Optional[dict]:
        """The sampled-phase cursor recorded for this level, or None."""
        return (self._resume.sampled.to_dict()
                if self._resume is not None
                and self._resume.sampled is not None else None)

    def group_resume(self, k: int, lo: int):
        if self._resume is None or self._resume.inflight_key != (k, lo):
            return None
        return (self._resume.inflight_group
                if self._resume.inflight_group is not None
                else self._resume.inflight_super)

    # -- record side --------------------------------------------------------
    def record_plan(self, plan: dict) -> None:
        self.plan = plan

    def on_group_state(self, k: int, lo: int, state) -> None:
        self.inflight_key = (k, lo)
        if isinstance(state, SuperBlockState):
            self.inflight_super, self.inflight_group = state, None
        else:
            self.inflight_group, self.inflight_super = state, None
        self._session._on_state_update()

    def on_group_done(self, k: int, lo: int, idxs, outcomes,
                      dispatches: int, block_peaks=None,
                      replans: int = 0) -> None:
        self.groups_done.append(GroupDone(
            k=k, lo=lo, idxs=list(idxs), outcomes=list(outcomes),
            dispatches=dispatches,
            block_peaks=(None if block_peaks is None
                         else [int(x) for x in block_peaks]),
            replans=int(replans)))
        self.inflight_key = None
        self.inflight_group = None
        self.inflight_super = None

    def drop_inflight(self) -> None:
        """Discard the in-flight group/super-block state (plane fallback: a
        batched re-run of the level cannot consume a distributed
        super-block cursor; completed groups stay, their outcomes are
        plane-agnostic)."""
        self.inflight_key = None
        self.inflight_group = None
        self.inflight_super = None
        if self._resume is not None:
            # the resume cursor may hold the other plane's in-flight state
            self._resume = dataclasses.replace(
                self._resume, inflight_key=None, inflight_group=None,
                inflight_super=None)

    def on_sampled(self, d: dict) -> None:
        """Sampled-phase snapshot point (after each sample group and when
        classification lands) — store the cursor and trigger the cadence."""
        self.sampled = SampledCursor.from_dict(d)
        self._session._on_state_update()

    def cursor(self) -> LevelCursor:
        return LevelCursor(
            level=self.level,
            groups_done=list(self.groups_done),
            inflight_key=self.inflight_key,
            inflight_group=self.inflight_group,
            inflight_super=self.inflight_super,
            plan=self.plan,
            sampled=self.sampled,
        )


class _SessionHooks:
    """The `mine()`-facing hooks surface (see `flexis.mine`)."""

    def __init__(self, session: "MiningSession",
                 resume_state: Optional[SessionState]):
        self._session = session
        self._resume = resume_state

    def loop_resume(self) -> MiningLoopState:
        # a fresh run resumes from the synthesized level-0 boundary: the
        # same state `mine()` would build, without listing the graph's
        # edge patterns a second time
        return self._session._boundary

    def pin_calibration(self, loaded: dict) -> dict:
        """Pin the planner's cost model to the session: a fresh run stores
        the loaded constants in every snapshot; a resumed run returns the
        stored ones, so replanning is identical across processes even if
        the calibration file changed in between.  (It reads the resume
        state the hooks were built with, so it does not matter that
        `mine()` calls it before `loop_resume`.)"""
        if (self._resume is not None
                and self._resume.calibration is not None):
            self._session._calibration = self._resume.calibration
        else:
            self._session._calibration = loaded
        return self._session._calibration

    def level_hooks(self, level: int) -> _LevelRecorder:
        cursor = None
        if (self._resume is not None and self._resume.cursor is not None
                and self._resume.cursor.level == level):
            cursor = self._resume.cursor
        rec = _LevelRecorder(self._session, level, cursor)
        self._session._recorder = rec
        return rec

    def on_level_end(self, loop: MiningLoopState) -> None:
        self._session._on_level_end(loop)


class MiningSession:
    """A resumable mining run bound to a checkpoint directory.

    Args:
      g: the data graph (must be byte-identical across resumes — validated
        via a fingerprint stored in every snapshot).
      cfg: `MiningConfig`; on the distributed plane an unset
        ``blocks_per_super`` is pinned to `DEFAULT_BLOCKS_PER_SUPER`.
      checkpoint_dir: snapshot root (one `train/checkpoint.py` step per
        snapshot).
      device: where to mine (``"cuda"`` unless the caller asks for the
        CPU; asking for CUDA without a card raises).  Resumed metric state
        is placed here.
      calibration: the planner calibration file `mine()` loads (None: its
        default search); a resumed run replans with the constants pinned
        in the snapshot instead.
      checkpoint_every: snapshot cadence in carried-state updates (root
        blocks, super-blocks, sample groups); level boundaries always
        snapshot.  ``0``
        disables mid-level snapshots (boundaries only).
      keep_last: retention, forwarded to `checkpoint.save`.
      resume: ``"auto"`` (continue a snapshot when one exists),
        ``"never"`` (ignore snapshots; fresh run), or ``"must"`` (raise
        unless a snapshot exists).
      meta: optional JSON-serializable dict stored in every snapshot
        (dataset provenance etc.; not validated on resume).
      async_saves: write mid-run snapshots through
        `checkpoint.save_async` (depth-1 write-behind: each snapshot first
        drains — and surfaces any error of — the previous one).  The final
        snapshot of a run is always synchronous.
      health: a `RunHealth` to record recoveries into (shared with
        `mine()`; a fresh one when omitted).
    """

    def __init__(self, g: DataGraph, cfg: MiningConfig,
                 checkpoint_dir, *, device="cuda",
                 calibration: Optional[str] = None,
                 checkpoint_every: int = 1,
                 keep_last: int = 3, resume: str = "auto",
                 meta: Optional[dict] = None, async_saves: bool = True,
                 health: Optional[RunHealth] = None):
        if resume not in ("auto", "never", "must"):
            raise ValueError('resume must be "auto", "never" or "must"')
        if checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if cfg.execution == "distributed" and cfg.blocks_per_super is None:
            cfg = dataclasses.replace(
                cfg, blocks_per_super=DEFAULT_BLOCKS_PER_SUPER)
        self.g = g
        self.cfg = cfg
        self.device = resolve_device(device)
        self.calibration = calibration
        self.dir = Path(checkpoint_dir)
        self.checkpoint_every = int(checkpoint_every)
        self.keep_last = keep_last
        self.meta = meta or {}
        self._resume_mode = resume
        self._fingerprint = session_fingerprint(g, cfg)

        self._step = -1                 # last written snapshot step
        self._updates = 0               # state updates since last snapshot
        self._recorder: Optional[_LevelRecorder] = None
        self._boundary: Optional[MiningLoopState] = None
        self._calibration: Optional[dict] = None  # pinned planner constants
        self._t0 = 0.0
        self._elapsed0 = 0.0
        self.snapshots_written = 0
        self._async = bool(async_saves)
        self._final_save = False        # next _save is the run's last
        self._preempt_requested = False
        self.health = health if health is not None else RunHealth()
        # under a process group rank 0 alone writes; the others keep the
        # same step count and fire the same fault points
        self._writer = distributed_lib.process_rank() == 0

    def request_preempt(self) -> None:
        """Ask the run to stop at the next snapshot point.

        Signal-handler safe (sets a flag).  The run keeps mining until
        the next snapshot is fully committed — at the next state update or
        level boundary — then raises `PreemptedError` out of `run()`.  The
        directory then holds a consistent snapshot; a later run resumes it.
        """
        self._preempt_requested = True

    # -- persistence --------------------------------------------------------
    def _elapsed(self) -> float:
        return self._elapsed0 + (time.monotonic() - self._t0)

    def _drain_pending(self) -> None:
        """Join in-flight background writes, surfacing collected errors.

        The first error is recorded in `RunHealth` and re-raised — a
        background snapshot write failing is the caller's problem (the
        run's durability just changed), never a daemon thread's.
        """
        errs = ckpt.wait_pending(raise_errors=False)
        if errs:
            self.health.record(
                "save_async_failure",
                f"background snapshot write failed: "
                f"{type(errs[0]).__name__}: {errs[0]}", step=self._step)
            raise errs[0]

    def _agree_preempt(self) -> None:
        """The ranks of a group stop together: a preemption one of them
        received holds for all (a rank alone would leave the others in a
        collective).  Called at every snapshot point."""
        self._preempt_requested = distributed_lib.world_any(
            self._preempt_requested)

    def _save(self, state: SessionState) -> None:
        self._step += 1
        if self._writer:
            self._write(state)
        self.snapshots_written += 1
        self._updates = 0
        faults.fire("session.snapshot", step=self._step)
        if self._preempt_requested:
            self.health.record(
                "preempted", f"stopped after committed snapshot "
                f"step {self._step}", step=self._step)
            raise PreemptedError(
                f"preempted; snapshot step {self._step} committed under "
                f"{self.dir} — resume to continue")

    def _write(self, state: SessionState) -> None:
        if state.calibration is None:
            state = dataclasses.replace(state, calibration=self._calibration)
        leaves, extra = encode_session(state, self.cfg.metric)
        extra["fingerprint"] = self._fingerprint
        extra["meta"] = self.meta
        # depth-1 write-behind: drain (and surface any failure of) the
        # previous background write before starting the next, so snapshot
        # writes stay ordered and at most one overlaps compute
        self._drain_pending()
        sync = (not self._async or self._final_save
                or self._preempt_requested)
        if sync:
            ckpt.save(self.dir, self._step, leaves, extra=extra,
                      keep_last=self.keep_last, health=self.health)
        else:
            ckpt.save_async(self.dir, self._step, leaves, extra=extra,
                            keep_last=self.keep_last, health=self.health)

    def _on_state_update(self) -> None:
        """Called by the recorder after every carried-state update."""
        self._agree_preempt()
        self._updates += 1
        if not self._preempt_requested:  # a preempt snapshots immediately
            if self.checkpoint_every == 0:
                return
            if self._updates < self.checkpoint_every:
                return
        boundary = self._boundary
        assert boundary is not None and self._recorder is not None
        loop = dataclasses.replace(boundary, elapsed_s=self._elapsed())
        self._save(SessionState(loop=loop, cursor=self._recorder.cursor()))

    def _on_level_end(self, loop: MiningLoopState) -> None:
        self._agree_preempt()
        self._boundary = loop
        self._recorder = None
        # the final boundary (no candidates left) is the run's last write:
        # always synchronous, so `run()` returning implies durability
        self._final_save = not loop.cp
        self._save(SessionState(loop=loop))

    # -- run ----------------------------------------------------------------
    def run(self) -> MiningResult:
        """Mine (or continue mining) and return the `MiningResult`."""
        # drain writes a previous in-process session may have left in
        # flight; their errors are recorded, not raised — the snapshot they
        # failed to write is simply not there to resume from
        for e in ckpt.wait_pending(raise_errors=False):
            self.health.record(
                "save_async_failure",
                f"prior background snapshot write failed: "
                f"{type(e).__name__}: {e}")
        resume_state: Optional[SessionState] = None
        if self._resume_mode != "never":
            loaded = load_session(self.dir, self.cfg, device=self.device,
                                  fingerprint=self._fingerprint,
                                  health=self.health)
            if loaded is None and self._resume_mode == "must":
                raise FileNotFoundError(
                    f"resume='must' but no committed session snapshot "
                    f"under {self.dir}")
            if loaded is not None:
                resume_state, self._step = loaded
        if resume_state is not None:
            self._elapsed0 = resume_state.loop.elapsed_s
            self._boundary = resume_state.loop
        else:
            # synthesize the level-0 boundary so a kill inside the very
            # first level still has a base snapshot to hang its cursor on
            self._boundary = MiningLoopState(
                level=0, cp=initial_candidates(self.g), frequent=[],
                stats=[], per_level={}, searched=0,
                peak_bytes=self.g.nbytes(), elapsed_s=0.0)
        self._t0 = time.monotonic()
        hooks = _SessionHooks(self, resume_state)
        res = mine(self.g, self.cfg, device=self.device, hooks=hooks,
                   health=self.health, calibration=self.calibration)
        # the final boundary save is synchronous, so normally nothing is
        # pending here; a run with no levels at all never saved — either
        # way this is a cheap invariant, not a flush
        self._drain_pending()
        return res
