"""Atomic, verified checkpoints of nested tensor/array trees.

Layout (one directory per step):
    <root>/step_000123/
        manifest.json         # tree structure, shapes, dtypes, CRCs, extra
        arr_00000.npy …       # one file per leaf (full logical array)
        COMMIT                # written last — a step without COMMIT is junk

The reference's format (``repro.train.checkpoint``, format v2), so that two
snapshots cut at the same point of the same run compare leaf by leaf.

Guarantees:
  * atomic: writes go to step_XXXX.tmp/, fsync'd, then rename + COMMIT —
    a crash mid-save never corrupts the latest good checkpoint;
  * verified: the manifest carries a CRC-32 per leaf (format v2); `restore`
    checks every array against it and raises `CorruptCheckpointError` on
    silent bit-rot instead of handing back garbage (v1 manifests without
    CRCs still restore, unverified);
  * self-healing callers: `committed_steps` + per-step `restore` let a
    caller walk the retained COMMIT chain newest→oldest until a step
    verifies (`repro_torch.runtime.resume.load_session` does this);
  * retried: transient I/O errors during a save (`EIO`, `ENOSPC`, `EAGAIN`,
    `EINTR`) are retried with exponential backoff before giving up — the
    tmp-dir protocol makes a retried attempt indistinguishable from a
    first one;
  * device-free: leaves are saved as host arrays, so a restore may place
    them on any device (``restore(device=)``);
  * validated `extra`: `extra` must round-trip through JSON — `save`
    rejects non-serializable state up front (fail fast on the host, never
    a half-written manifest);
  * retention: keep_last prunes old steps after a successful COMMIT, and
    stale ``step_*.tmp`` directories abandoned by a crashed writer are
    swept on the next save — the sweep TTL is configurable
    (``stale_tmp_s`` / ``$REPRO_TORCH_STALE_TMP_S``) and *always* excludes
    tmp dirs this process is currently writing, so an aggressive TTL can
    never race an in-flight `save_async`.

Trees are nested dicts (keys in sorted order), lists and tuples whose
leaves are torch tensors, numpy arrays or scalars; ``None`` holds no leaf.

`save_async` copies every leaf to host memory on the caller's thread —
the port's metric states are updated in place, so a worker that read a
tensor later would write a later state than the snapshot's cursor says —
and writes the copies from a thread.  Background failures are never
swallowed: the first one is re-raised from `wait_pending()` or from the
next `save`/`save_async` call.

Fault injection: the write path fires named `repro_torch.runtime.faults`
points (``save.io``, ``save.array_write``, ``save.manifest``,
``save.pre_commit``, ``save.committed``) — no-ops unless a `FaultPlan` is
installed.
"""
from __future__ import annotations

import dataclasses
import errno
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "committed_steps",
           "wait_pending", "validate_extra", "CorruptCheckpointError",
           "LeafSpec", "tree_flatten", "tree_unflatten", "host_array",
           "TRANSIENT_ERRNOS", "DEFAULT_SAVE_RETRIES",
           "DEFAULT_RETRY_BACKOFF_S", "STALE_TMP_ENV"]

# format 2 = format 1 + per-leaf "crc32" in manifest["leaves"] entries
FORMAT_VERSION = 2

# a step_*.tmp untouched for this long was abandoned by a crashed writer
# (a live save_async thread is still appending/fsyncing well within this);
# override per call via save(stale_tmp_s=...) or globally via the env var
_STALE_TMP_S = 60.0
STALE_TMP_ENV = "REPRO_TORCH_STALE_TMP_S"

# save I/O errors worth retrying: transient device/FS conditions that a
# backoff can outlive
TRANSIENT_ERRNOS = frozenset({errno.EIO, errno.ENOSPC, errno.EAGAIN,
                              errno.EINTR})
DEFAULT_SAVE_RETRIES = 2
DEFAULT_RETRY_BACKOFF_S = 0.05

# in-flight background saves: (thread, error_slot) pairs.  error_slot is a
# one-element list the worker fills on failure
_PENDING: List[Tuple[threading.Thread, list]] = []
_PENDING_LOCK = threading.Lock()

# tmp dirs this process is writing right now — the stale sweep never
# touches them, whatever the TTL says
_ACTIVE_TMP: set = set()
_ACTIVE_LOCK = threading.Lock()


class CorruptCheckpointError(ValueError):
    """A committed step failed verification (CRC mismatch / bad manifest)."""


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf template for `restore`: the (shape, dtype) a leaf must have."""

    shape: Tuple[int, ...]
    dtype: Any = None


# ---------------------------------------------------------------------------
# trees: nested dicts / lists / tuples of leaves
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> Tuple[list, Any]:
    """(leaves, treedef) of ``tree``; dict keys are visited in sorted
    order, ``None`` holds no leaf, anything else that is not a dict, list
    or tuple is a leaf."""
    leaves: list = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return ("list" if isinstance(t, list) else "tuple",
                    tuple(walk(x) for x in t))
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Any:
    """Inverse of `tree_flatten`."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        items = [build(c) for c in d[1]]
        return items if kind == "list" else tuple(items)

    return build(treedef)


def _treedef_str(d) -> str:
    kind = d[0]
    if kind == "none":
        return "None"
    if kind == "leaf":
        return "*"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_treedef_str(c)}"
                               for k, c in zip(d[1], d[2])) + "}"
    inner = ", ".join(_treedef_str(c) for c in d[1])
    return f"[{inner}]" if kind == "list" else f"({inner})"


def host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a device tensor is copied to host)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype; cast "
                            "them before checkpointing")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# fault hook, extra validation
# ---------------------------------------------------------------------------

def _fire(point: str, **ctx) -> None:
    """Fault-injection hook (lazy import: train/ does not need runtime/ at
    import time).  One function call + None check with no plan installed."""
    from ..runtime import faults

    faults.fire(point, **ctx)


def validate_extra(extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Normalize + validate the opaque `extra` manifest slot.

    Returns the JSON round-trip of ``extra`` (so the caller sees exactly
    what a restore will see), raising a `TypeError` naming the offending
    key when any value is not JSON-serializable.  Nested cursors are fine;
    arrays and other device state belong in the tree, not here.
    """
    return json.loads(_ensure_json_extra(extra))


def _ensure_json_extra(extra: Optional[Dict[str, Any]]) -> str:
    """Serialize-validate ``extra`` once; returns the JSON text."""
    if extra is None:
        return "{}"
    if not isinstance(extra, dict):
        raise TypeError(f"extra must be a dict, got {type(extra).__name__}")
    try:
        return json.dumps(extra)
    except TypeError:
        for key, value in extra.items():
            try:
                json.dumps(value)
            except TypeError as e:
                raise TypeError(
                    f"extra[{key!r}] is not JSON-serializable: {e}") from e
        raise


def _stale_ttl(stale_tmp_s: Optional[float]) -> float:
    if stale_tmp_s is not None:
        return float(stale_tmp_s)
    env = os.environ.get(STALE_TMP_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return _STALE_TMP_S


def _raise_pending_errors() -> None:
    """Re-raise the first error a *finished* background save collected
    (non-blocking: running writers are checked at the next call)."""
    with _PENDING_LOCK:
        done = [(t, e) for t, e in _PENDING if not t.is_alive()]
        for entry in done:
            _PENDING.remove(entry)
    errs = [e[0] for _, e in done if e]
    if errs:
        raise errs[0]


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save(root: str | os.PathLike, step: int, tree, *,
         extra: Optional[Dict[str, Any]] = None, keep_last: int = 3,
         retries: int = DEFAULT_SAVE_RETRIES,
         retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
         stale_tmp_s: Optional[float] = None,
         health=None) -> Path:
    """Atomically persist ``tree`` (+ ``extra``) as step ``step``.

    Transient I/O errors (`TRANSIENT_ERRNOS`) are retried up to ``retries``
    times with exponential backoff starting at ``retry_backoff_s``; each
    retry is recorded on ``health`` (a `core.health.RunHealth`) when given.
    Also re-raises any error a previous `save_async` worker collected.
    """
    _ensure_json_extra(extra)  # fail fast, before any disk write
    _raise_pending_errors()
    for attempt in range(retries + 1):
        try:
            return _save_once(root, step, tree, extra=extra,
                              keep_last=keep_last, stale_tmp_s=stale_tmp_s)
        except OSError as e:
            if e.errno not in TRANSIENT_ERRNOS or attempt == retries:
                raise
            if health is not None:
                health.record(
                    "save_retry",
                    f"attempt {attempt + 1}/{retries + 1} hit "
                    f"{errno.errorcode.get(e.errno, e.errno)}: {e}",
                    step=step)
            time.sleep(retry_backoff_s * (2 ** attempt))
    raise AssertionError("unreachable")


def _save_once(root, step: int, tree, *, extra, keep_last: int,
               stale_tmp_s: Optional[float]) -> Path:
    extra = extra or {}
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    with _ACTIVE_LOCK:
        _ACTIVE_TMP.add(tmp)
    try:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _fire("save.io", step=step)

        leaves, treedef = tree_flatten(tree)
        manifest = {
            "format_version": FORMAT_VERSION,
            "step": step,
            "treedef": _treedef_str(treedef),
            "n_leaves": len(leaves),
            "extra": extra,
            "time": time.time(),
            "leaves": [],
        }
        for i, leaf in enumerate(leaves):
            arr = host_array(leaf)
            fpath = tmp / f"arr_{i:05d}.npy"
            np.save(fpath, arr)
            manifest["leaves"].append({
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr)),
            })
            _fire("save.array_write", path=fpath, step=step)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        _fire("save.manifest", path=tmp / "manifest.json", step=step)
        # fsync directory contents before commit
        for f in tmp.iterdir():
            fd = os.open(f, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _fire("save.pre_commit", step=step)
        (final / "COMMIT").write_text("ok")
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE_TMP.discard(tmp)
    _fire("save.committed", path=final, step=step)

    # retention — committed steps beyond keep_last, plus stale tmp dirs
    # abandoned by a writer that crashed before its rename (live tmp dirs
    # of this process are excluded via _ACTIVE_TMP regardless of age)
    steps = sorted(p for p in root.glob("step_????????")
                   if (p / "COMMIT").exists())
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    ttl = _stale_ttl(stale_tmp_s)
    with _ACTIVE_LOCK:
        active = set(_ACTIVE_TMP)
    for junk in root.glob("step_????????.tmp"):
        if junk in active:
            continue
        try:  # age-guarded: never race a concurrent writer's fresh tmp
            stale = time.time() - junk.stat().st_mtime > ttl
        except OSError:
            continue
        if stale:
            shutil.rmtree(junk, ignore_errors=True)
    return final


def save_async(root, step, tree, *, extra=None, keep_last: int = 3,
               retries: int = DEFAULT_SAVE_RETRIES,
               retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
               stale_tmp_s: Optional[float] = None, health=None):
    """Copy the tree to host memory now, write it to disk in a thread.

    Every leaf is copied on the caller's thread (a device tensor to host,
    a host tensor or array into a fresh array), so a state updated in
    place after this call returns does not reach the snapshot.  Returns
    the worker thread; a worker that fails records its exception and
    `wait_pending` or the next `save`/`save_async` re-raises it.
    """
    _raise_pending_errors()
    leaves, treedef = tree_flatten(tree)
    host_leaves = [np.array(host_array(leaf), copy=True) for leaf in leaves]
    snapshot = tree_unflatten(treedef, host_leaves)

    err: list = []

    def _work():
        try:
            save(root, step, snapshot, extra=extra, keep_last=keep_last,
                 retries=retries, retry_backoff_s=retry_backoff_s,
                 stale_tmp_s=stale_tmp_s, health=health)
        except BaseException as e:  # noqa: BLE001 - collected, not dropped
            err.append(e)

    t = threading.Thread(target=_work, daemon=True)
    t.start()
    with _PENDING_LOCK:
        _PENDING.append((t, err))
    return t


def wait_pending(raise_errors: bool = True) -> List[BaseException]:
    """Join every in-flight background save.

    Re-raises the first collected worker error (``raise_errors=True``) or
    returns the list of errors (``raise_errors=False`` — the session
    runtime drains this way and records them in `RunHealth`).
    """
    errs: List[BaseException] = []
    while True:
        with _PENDING_LOCK:
            if not _PENDING:
                break
            t, e = _PENDING.pop()
        t.join()
        errs.extend(e)
    if errs and raise_errors:
        raise errs[0]
    return errs


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def committed_steps(root) -> List[int]:
    """All committed step indices under ``root``, ascending."""
    root = Path(root)
    if not root.exists():
        return []
    return sorted(int(p.name.split("_")[1])
                  for p in root.glob("step_????????")
                  if (p / "COMMIT").exists())


def latest_step(root) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


def restore(root, tree_like, *, step: Optional[int] = None,
            device=None, shardings=None, verify: bool = True
            ) -> Tuple[Any, Dict[str, Any], int]:
    """Restore into the structure of ``tree_like`` (shapes must match).

    ``tree_like``'s leaves are anything with a ``shape`` (tensors, arrays,
    `LeafSpec`).  Leaves come back as torch tensors on ``device`` (the CPU
    when None).  ``shardings``: an optional tree like ``tree_like`` of
    ``models.sharding.NamedSharding`` (None for a whole leaf): each leaf
    is cut to this rank's shard before it moves to ``device`` — the
    stored arrays are whole, whatever mesh wrote them, so a restore onto
    another mesh needs no other format.  ``verify`` checks each array
    against its manifest CRC-32 (format-v2 checkpoints; v1 manifests
    without CRCs load unverified) and raises `CorruptCheckpointError` on
    a mismatch.  Returns (tree, extra, step).
    """
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = root / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"checkpoint {d} has no COMMIT (partial write?)")
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except ValueError as e:
        raise CorruptCheckpointError(f"{d}: unreadable manifest: {e}") from e
    leaves_like, treedef = tree_flatten(tree_like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"leaf count mismatch: ckpt {manifest['n_leaves']} "
                         f"vs tree {len(leaves_like)}")
    sh_leaves = (tree_flatten(shardings)[0] if shardings is not None
                 else [None] * len(leaves_like))
    if len(sh_leaves) != len(leaves_like):
        raise ValueError("shardings must have one entry a leaf")
    out = []
    for i, (like, sh) in enumerate(zip(leaves_like, sh_leaves)):
        try:
            arr = np.load(d / f"arr_{i:05d}.npy")
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(
                f"{d}: leaf {i} unreadable: {e}") from e
        want = tuple(getattr(like, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: shape {arr.shape} != expected {want}")
        stored_crc = manifest["leaves"][i].get("crc32")
        if verify and stored_crc is not None:
            got_crc = zlib.crc32(np.ascontiguousarray(arr))
            if got_crc != stored_crc:
                raise CorruptCheckpointError(
                    f"{d}: leaf {i} CRC mismatch "
                    f"(stored {stored_crc:#010x}, got {got_crc:#010x}) — "
                    f"silent corruption")
        t = torch.from_numpy(arr)
        if sh is not None:
            t = sh.shard(t)
        out.append(t if device is None else t.to(device))
    tree = tree_unflatten(treedef, out)
    return tree, manifest.get("extra", {}), step
