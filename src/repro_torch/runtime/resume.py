"""Snapshot loading + validation for mining sessions.

Split from `session.py` so a restore can be driven standalone (inspect a
checkpoint directory, validate it against a config, rebuild the
`SessionState`) without constructing a `MiningSession`.

Leaf shapes and dtypes are read back from the checkpoint *manifest*, not
from a caller-supplied template, so the loader needs no advance knowledge
of bucket sizes or pattern counts; `state.decode_session` places the
in-flight metric state on the session's device.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.flexis import MiningConfig
from ..core.graph import DataGraph
from ..train import checkpoint as ckpt

from .state import SessionState, decode_session

__all__ = ["session_fingerprint", "latest_snapshot", "load_session",
           "SessionMismatch"]


class SessionMismatch(ValueError):
    """A snapshot exists but was written by an incompatible run."""


def session_fingerprint(g: DataGraph, cfg: MiningConfig) -> Dict[str, Any]:
    """Identity of a mining run: the graph (structure + labels) and every
    result-relevant config knob.  Wall-clock budget (``time_limit_s``) is
    excluded — a *killed* run may be resumed under a bigger budget without
    changing any mined value.  The config part is the port's
    `MiningConfig`, so it lacks the reference's JAX-only matcher fields
    (``match.expansion``, ``match.pallas_interpret``)."""
    cfg_d = dataclasses.asdict(cfg)
    cfg_d.pop("time_limit_s", None)
    return {
        "graph": {
            "n": int(g.n),
            "n_edges": int(g.n_edges),
            "n_labels": int(g.n_labels),
            "labels_crc": zlib.crc32(np.ascontiguousarray(g.labels)),
            "edges_crc": zlib.crc32(np.ascontiguousarray(g.edge_keys)),
        },
        "config": cfg_d,
    }


def latest_snapshot(checkpoint_dir) -> Optional[int]:
    """Step index of the newest committed session snapshot, or None."""
    return ckpt.latest_step(Path(checkpoint_dir))


def _manifest(checkpoint_dir: Path, step: int) -> Dict[str, Any]:
    d = Path(checkpoint_dir) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text())


def _load_step(checkpoint_dir: Path, step: int, cfg: MiningConfig,
               fingerprint: Optional[Dict[str, Any]], device
               ) -> Tuple[SessionState, int]:
    """Load + validate one committed step (raises on any defect)."""
    manifest = _manifest(checkpoint_dir, step)
    # the leaf template comes from the manifest itself
    template = [ckpt.LeafSpec(tuple(leaf["shape"]), np.dtype(leaf["dtype"]))
                for leaf in manifest["leaves"]]
    leaves, extra, step = ckpt.restore(checkpoint_dir, template, step=step)
    stored = extra.get("fingerprint")
    if fingerprint is not None and stored != fingerprint:
        raise SessionMismatch(
            f"snapshot under {checkpoint_dir} was written by a different "
            f"run:\n  stored:  {stored}\n  current: {fingerprint}")
    leaves = [leaf.numpy() for leaf in leaves]
    return decode_session(leaves, extra, cfg.metric, device=device), step


def load_session(checkpoint_dir, cfg: MiningConfig, *, device,
                 step: Optional[int] = None,
                 fingerprint: Optional[Dict[str, Any]] = None,
                 health=None,
                 ) -> Optional[Tuple[SessionState, int]]:
    """Load (SessionState, step) from the newest *healthy* snapshot, its
    in-flight metric state on ``device``.

    Self-healing restore: when the newest committed step turns out corrupt
    — unreadable/garbage manifest, missing array file, CRC mismatch
    (`checkpoint.CorruptCheckpointError`), undecodable session state — the
    loader falls back across the retained COMMIT chain, newest→oldest.
    Every skipped step is recorded on ``health`` (a `RunHealth`) as a
    ``restore_fallback`` event (plus ``checksum_mismatch`` for a CRC
    failure).  The worst case (every retained step corrupt) returns None,
    i.e. a fresh run — degraded but never wrong.

    An explicit ``step`` is strict: its defects propagate.  A
    `SessionMismatch` is never fallen past either — an older step of the
    same directory would mismatch identically.  A distributed in-flight
    cursor (a `SuperBlockState`) decodes like any other and the
    distributed plane continues it, at any world size.

    Returns None when the directory holds no (healthy) committed snapshot.
    """
    checkpoint_dir = Path(checkpoint_dir)
    if step is not None:
        return _load_step(checkpoint_dir, step, cfg, fingerprint, device)
    steps = ckpt.committed_steps(checkpoint_dir)
    for s in reversed(steps):
        try:
            return _load_step(checkpoint_dir, s, cfg, fingerprint, device)
        except SessionMismatch:
            raise
        except (OSError, ValueError, KeyError, TypeError) as e:
            # CorruptCheckpointError is a ValueError; FileNotFoundError
            # (missing array/manifest) is an OSError; decode_session format
            # defects surface as ValueError/KeyError/TypeError
            if health is not None:
                if (isinstance(e, ckpt.CorruptCheckpointError)
                        and "CRC mismatch" in str(e)):
                    health.record("checksum_mismatch", str(e), step=s)
                health.record(
                    "restore_fallback",
                    f"step {s} corrupt ({type(e).__name__}: {e}); "
                    f"falling back", step=s)
            continue
    return None
