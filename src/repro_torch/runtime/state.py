"""Session-state codec — the mining loop's full state as (leaves, extra).

A mining session snapshot has two halves, mirroring what
`train/checkpoint.py` carries:

  * the **leaves**: the metric state of the in-flight group — the mIS
    ``(bitmap, count)`` pair of a batched `GroupState`, an MNI image table
    or a fractional count table — as host arrays with the reference's
    dtypes and shapes (the mIS bitmap as uint32 words, the same bits as
    the port's int32 words), so that a snapshot of the port and one of the
    reference cut at the same point compare leaf by leaf;
  * the **extra** manifest slot: every host-side value — the per-level
    frequent-pattern frontier (patterns + `PatternStats`), the candidates
    of the next level, τ/accounting bookkeeping, and the
    level/pattern-group/block cursor — as plain JSON, key for key the
    reference's (``repro.runtime.state``).

`encode_session` / `decode_session` are exact inverses for every field of
the resume contract.  The sampled cursor's escalation-reuse records
(``groups[...]["replay"]``) are int32 arrays in the port and JSON lists in
the reference: the codec writes lists and reads them back as arrays.
``decode_session`` places the in-flight metric state on the session's
device.  The distributed plane's in-flight cursor (`SuperBlockState`) is
saved in the reference's format: its replicated bitmaps (as uint32 words)
and counts are the two leaves, the rest goes into ``extra``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.batched import GroupState, PatternOutcome
from ..core.distributed import SuperBlockState
from ..core.flexis import MiningLoopState, PatternStats
from ..core.pattern import Pattern
from ..train.checkpoint import host_array

__all__ = [
    "FORMAT", "GroupDone", "LevelCursor", "SampledCursor", "SessionState",
    "encode_session", "decode_session",
    "encode_pattern", "decode_pattern",
]

FORMAT = 1


# ---------------------------------------------------------------------------
# host-object codecs (JSON-dict ⟷ dataclass)
# ---------------------------------------------------------------------------

def encode_pattern(p: Pattern) -> Dict[str, Any]:
    return {"labels": p.labels.tolist(), "edges": p.edges()}


def decode_pattern(d: Dict[str, Any]) -> Pattern:
    labels = np.asarray(d["labels"], np.int32)
    adj = np.zeros((labels.shape[0], labels.shape[0]), bool)
    for i, j in d["edges"]:
        adj[i, j] = True
    return Pattern(adj, labels)


def _encode_stats(st: PatternStats) -> Dict[str, Any]:
    return {
        "pattern": encode_pattern(st.pattern),
        "support": int(st.support),
        "tau": int(st.tau),
        "frequent": bool(st.frequent),
        "embeddings_found": int(st.embeddings_found),
        "overflowed": bool(st.overflowed),
        "blocks_run": int(st.blocks_run),
        "max_count": int(st.max_count),
        "dispatches": int(st.dispatches),
        "estimated": bool(st.estimated),
    }


def _decode_stats(d: Dict[str, Any]) -> PatternStats:
    return PatternStats(
        pattern=decode_pattern(d["pattern"]),
        support=d["support"],
        tau=d["tau"],
        frequent=d["frequent"],
        embeddings_found=d["embeddings_found"],
        overflowed=d["overflowed"],
        blocks_run=d["blocks_run"],
        max_count=d.get("max_count", 0),
        dispatches=d.get("dispatches", 0),
        estimated=d.get("estimated", False),
    )


def _encode_outcome(o: PatternOutcome) -> Dict[str, Any]:
    return {
        "support": int(o.support),
        "frequent": bool(o.frequent),
        "embeddings_found": int(o.embeddings_found),
        "overflowed": bool(o.overflowed),
        "blocks_run": int(o.blocks_run),
        "max_count": int(o.max_count),
        "estimated": bool(o.estimated),
    }


def _decode_outcome(d: Dict[str, Any]) -> PatternOutcome:
    return PatternOutcome(**d)


def _encode_loop(loop: MiningLoopState) -> Dict[str, Any]:
    return {
        "level": loop.level,
        "cp": [encode_pattern(p) for p in loop.cp],
        "frequent": [
            {"pattern": encode_pattern(p), "support": int(s)}
            for p, s in loop.frequent
        ],
        "stats": [_encode_stats(st) for st in loop.stats],
        "per_level": {str(k): v for k, v in loop.per_level.items()},
        "searched": loop.searched,
        "peak_bytes": loop.peak_bytes,
        "elapsed_s": loop.elapsed_s,
        "timed_out": loop.timed_out,
    }


def _decode_loop(d: Dict[str, Any]) -> MiningLoopState:
    return MiningLoopState(
        level=d["level"],
        cp=[decode_pattern(p) for p in d["cp"]],
        frequent=[(decode_pattern(f["pattern"]), f["support"])
                  for f in d["frequent"]],
        stats=[_decode_stats(st) for st in d["stats"]],
        per_level={int(k): v for k, v in d["per_level"].items()},
        searched=d["searched"],
        peak_bytes=d["peak_bytes"],
        elapsed_s=d["elapsed_s"],
        timed_out=d["timed_out"],
    )


# ---------------------------------------------------------------------------
# the sampled cursor's replay records: int32 arrays ⟷ JSON lists
# ---------------------------------------------------------------------------

def _replay_to_json(replay: List[Dict[str, dict]]) -> List[Dict[str, dict]]:
    return [{pos: {**rec, "emb": np.asarray(rec["emb"]).tolist()}
             for pos, rec in per.items()} for per in replay]


def _replay_from_json(replay: List[Dict[str, dict]], k: int
                      ) -> List[Dict[str, dict]]:
    return [{pos: {**rec, "emb": np.asarray(rec["emb"], np.int32
                                            ).reshape(-1, k)}
             for pos, rec in per.items()} for per in replay]


def _groups_to_json(groups: Dict[str, dict]) -> Dict[str, dict]:
    """A fresh JSON copy of the sample-pass groups (the live dict keeps
    growing while an asynchronous snapshot of it is written)."""
    out = {}
    for gk, g in groups.items():
        g = dict(g)
        if g.get("replay") is not None:
            g["replay"] = _replay_to_json(g["replay"])
        out[gk] = g
    return out


def _groups_from_json(groups: Dict[str, dict]) -> Dict[str, dict]:
    out = {}
    for gk, g in groups.items():
        g = dict(g)
        if g.get("replay") is not None:
            g["replay"] = _replay_from_json(g["replay"], int(gk.split(":")[0]))
        out[gk] = g
    return out


# ---------------------------------------------------------------------------
# session state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GroupDone:
    """One completed (k, lo) group of the in-flight level."""

    k: int
    lo: int
    idxs: List[int]                     # level eval-set indices
    outcomes: List[PatternOutcome]
    dispatches: int
    # per-block-id peak frontier occupancy over the blocks this group ran
    # (length = total root blocks) — the sampled plane's next-level draw
    # weights
    block_peaks: Optional[List[int]] = None
    # within-level cap replans this group performed (auto plane only)
    replans: int = 0


@dataclasses.dataclass
class SampledCursor:
    """Mid-level resume state specific to the sampled plane.

    ``phase`` is ``"sample"`` (the weighted sample pass is running; the
    completed groups live in ``groups``) or ``"escalate"`` (classification
    finished — ``classify`` pins its verdicts — and the exact escalation
    pass is running, its own group progress tracked by the ordinary
    `LevelCursor` machinery).  ``positions``/``key`` replay the draw
    verbatim so a resume never re-samples.
    """

    phase: str                          # "sample" | "escalate"
    positions: List[int]                # round-0 schedule indices (asc)
    key: List[int]                      # RNG key words of the draw
    # completed sample-pass groups, keyed "k:lo:r<round>" →
    # {"idxs", "ys", "outs", "dispatches", "block_peaks", "replay"}
    groups: Dict[str, dict]
    # phase == "escalate" only: {"escalate", "pruned", "rounds",
    # "ci_width_mean"}
    classify: Optional[dict] = None
    # adaptive rounds past the plan's round 0, in order
    rounds: List[dict] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "phase": self.phase,
            "positions": [int(x) for x in self.positions],
            "key": [int(x) for x in self.key],
            "rounds": self.rounds,
            "groups": self.groups,
            "classify": self.classify,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SampledCursor":
        return cls(
            phase=str(d["phase"]),
            positions=[int(x) for x in d["positions"]],
            key=[int(x) for x in d["key"]],
            rounds=list(d.get("rounds") or []),
            groups=dict(d.get("groups") or {}),
            classify=d.get("classify"),
        )


@dataclasses.dataclass
class LevelCursor:
    """Mid-level resume state: which groups of the in-flight level finished
    and the carried state of the one that was running when we snapshotted."""

    level: int
    groups_done: List[GroupDone]
    inflight_key: Optional[Tuple[int, int]] = None       # (k, lo)
    inflight_group: Optional[GroupState] = None          # batched plane
    inflight_super: Optional[SuperBlockState] = None     # distributed plane
    # the planner's recorded decision for the in-flight level
    # (`LevelPlan.to_dict()`; None under forced execution modes except
    # "sampled", which records the level's block draw here) — a resume
    # replays it instead of re-planning
    plan: Optional[Dict[str, Any]] = None
    # sampled plane only: the sample-pass / escalation phase cursor
    sampled: Optional[SampledCursor] = None


@dataclasses.dataclass
class SessionState:
    """A full mining-session snapshot: the last level-boundary loop state
    plus (optionally) the cursor into the level running past it."""

    loop: MiningLoopState
    cursor: Optional[LevelCursor] = None
    # the pinned planner cost model (`CostModel.to_dict()` + n_devices): a
    # resumed process replans future levels with the same model even if
    # the calibration file changed (or vanished) in between
    calibration: Optional[Dict[str, Any]] = None


# ---------------------------------------------------------------------------
# (leaves, extra) codec
# ---------------------------------------------------------------------------

def _mis_state(metric: str) -> bool:
    return metric in ("mis", "mis_luby")


def encode_session(state: SessionState, metric: str,
                   ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """Flatten a `SessionState` into (host array leaves, JSON extra).

    The leaves are the in-flight metric state (none when the snapshot sits
    on a level boundary); everything else goes into ``extra``.
    ``extra["cursor"]`` is the compact level/pattern-group/block index.
    """
    leaves: List[np.ndarray] = []
    extra: Dict[str, Any] = {
        "format": FORMAT,
        "loop": _encode_loop(state.loop),
        "cursor": {"level": state.loop.level, "group": None, "block": None},
    }
    if state.calibration is not None:
        extra["calibration"] = state.calibration
    if state.cursor is None:
        extra["pytree"] = {"kind": "none", "n_leaves": 0}
        return leaves, extra

    cur = state.cursor
    sampled = None
    if cur.sampled is not None:
        sampled = cur.sampled.to_dict()
        sampled["rounds"] = [dict(r) for r in sampled["rounds"]]
        sampled["groups"] = _groups_to_json(sampled["groups"])
    c: Dict[str, Any] = {
        "level": cur.level,
        "groups_done": [
            {
                "k": gd.k, "lo": gd.lo, "idxs": list(map(int, gd.idxs)),
                "outcomes": [_encode_outcome(o) for o in gd.outcomes],
                "dispatches": gd.dispatches,
                "block_peaks": (None if gd.block_peaks is None
                                else [int(x) for x in gd.block_peaks]),
                "replans": int(gd.replans),
            }
            for gd in cur.groups_done
        ],
        "inflight_key": (list(cur.inflight_key)
                         if cur.inflight_key is not None else None),
        "plan": cur.plan,
        "sampled": sampled,
    }
    extra["cursor"]["level"] = cur.level
    if cur.inflight_group is not None:
        gs = cur.inflight_group
        if _mis_state(metric):
            bitmaps, counts = (host_array(s) for s in gs.state)
            # the port's int32 words as the reference's uint32 words
            leaves = [np.ascontiguousarray(bitmaps, np.int32).view(np.uint32),
                      np.asarray(counts, np.int32)]
        else:
            leaves = [host_array(gs.state)]
        gs_max = (gs.max_count if gs.max_count is not None
                  else np.zeros_like(gs.supports))
        c["inflight"] = {
            "plane": "batched",
            "next_block": int(gs.next_block),
            "bucket_map": np.asarray(gs.bucket_map).tolist(),
            "supports": gs.supports.tolist(),
            "found": gs.found.tolist(),
            "overflowed": gs.overflowed.tolist(),
            "blocks_run": gs.blocks_run.tolist(),
            "dispatches": int(gs.dispatches),
            "max_count": gs_max.tolist(),
            "block_peaks": (None if gs.block_peaks is None
                            else np.asarray(gs.block_peaks).tolist()),
            "cap": (None if gs.cap is None else int(gs.cap)),
            "replans": int(gs.replans),
        }
        extra["cursor"]["group"] = list(cur.inflight_key)
        extra["cursor"]["block"] = int(gs.next_block)
    elif cur.inflight_super is not None:
        ss = cur.inflight_super
        leaves = [np.ascontiguousarray(host_array(ss.bitmaps), np.int32
                                       ).view(np.uint32),
                  np.asarray(host_array(ss.counts), np.int32)]
        ss_max = (ss.max_count if ss.max_count is not None
                  else np.zeros_like(ss.found))
        c["inflight"] = {
            "plane": "distributed",
            "next_block": int(ss.next_block),
            "found": ss.found.tolist(),
            "overflowed": ss.overflowed.tolist(),
            "blocks_run": ss.blocks_run.tolist(),
            "super_blocks_run": int(ss.super_blocks_run),
            "dispatches": int(ss.dispatches),
            "max_count": ss_max.tolist(),
        }
        extra["cursor"]["group"] = list(cur.inflight_key)
        extra["cursor"]["block"] = int(ss.next_block)
    else:
        c["inflight"] = None
    extra["level_cursor"] = c
    extra["pytree"] = {"kind": ("mis" if _mis_state(metric) else metric)
                       if leaves else "none",
                       "n_leaves": len(leaves)}
    return leaves, extra


def decode_session(leaves: List[np.ndarray], extra: Dict[str, Any],
                   metric: str, *, device) -> SessionState:
    """Inverse of `encode_session`; the in-flight metric state becomes
    tensors on ``device``."""
    if extra.get("format") != FORMAT:
        raise ValueError(
            f"unknown session snapshot format {extra.get('format')!r} "
            f"(this build reads format {FORMAT})")
    loop = _decode_loop(extra["loop"])
    calibration = extra.get("calibration")
    c = extra.get("level_cursor")
    if c is None:
        return SessionState(loop=loop, calibration=calibration)

    sampled = None
    if c.get("sampled") is not None:
        sampled = SampledCursor.from_dict(c["sampled"])
        sampled.groups = _groups_from_json(sampled.groups)
    cursor = LevelCursor(
        level=c["level"],
        groups_done=[
            GroupDone(
                k=gd["k"], lo=gd["lo"], idxs=list(gd["idxs"]),
                outcomes=[_decode_outcome(o) for o in gd["outcomes"]],
                dispatches=gd["dispatches"],
                block_peaks=gd.get("block_peaks"),
                replans=int(gd.get("replans", 0)),
            )
            for gd in c["groups_done"]
        ],
        inflight_key=(tuple(c["inflight_key"])
                      if c["inflight_key"] is not None else None),
        plan=c.get("plan"),
        sampled=sampled,
    )
    inflight = c.get("inflight")
    n_leaves = extra["pytree"]["n_leaves"]
    if inflight is not None and n_leaves != len(leaves):
        raise ValueError(f"leaf count mismatch: {n_leaves} vs {len(leaves)}")
    if inflight is not None and inflight["plane"] == "batched":
        if _mis_state(metric):
            bitmaps = np.ascontiguousarray(leaves[0]).view(np.int32)
            devstate = (torch.as_tensor(bitmaps).to(device, copy=True),
                        torch.as_tensor(np.asarray(leaves[1], np.int32)
                                        ).to(device, copy=True))
        else:
            devstate = torch.as_tensor(np.asarray(leaves[0])).to(
                device, copy=True)
        cursor.inflight_group = GroupState(
            next_block=inflight["next_block"],
            bucket_map=np.asarray(inflight["bucket_map"], np.int64),
            state=devstate,
            supports=np.asarray(inflight["supports"], np.int64),
            found=np.asarray(inflight["found"], np.int64),
            overflowed=np.asarray(inflight["overflowed"], bool),
            blocks_run=np.asarray(inflight["blocks_run"], np.int64),
            dispatches=inflight["dispatches"],
            max_count=np.asarray(
                inflight.get("max_count",
                             [0] * len(inflight["supports"])), np.int64),
            block_peaks=(None if inflight.get("block_peaks") is None
                         else np.asarray(inflight["block_peaks"], np.int64)),
            cap=inflight.get("cap"),
            replans=int(inflight.get("replans", 0)),
        )
    elif inflight is not None and inflight["plane"] == "distributed":
        bitmaps = np.ascontiguousarray(leaves[0]).view(np.int32)
        cursor.inflight_super = SuperBlockState(
            next_block=inflight["next_block"],
            bitmaps=torch.as_tensor(bitmaps).to(device, copy=True),
            counts=torch.as_tensor(np.asarray(leaves[1], np.int32)
                                   ).to(device, copy=True),
            found=np.asarray(inflight["found"], np.int64),
            overflowed=np.asarray(inflight["overflowed"], bool),
            blocks_run=np.asarray(inflight["blocks_run"], np.int64),
            super_blocks_run=inflight["super_blocks_run"],
            dispatches=inflight["dispatches"],
            max_count=np.asarray(
                inflight.get("max_count",
                             [0] * len(inflight["found"])), np.int64),
        )
    return SessionState(loop=loop, cursor=cursor, calibration=calibration)
