"""The port's checkpoint: atomicity, resume, retention, async, verification.

The properties of the reference's ``tests/train/test_checkpoint.py``, held
by `repro_torch.train.checkpoint` (trees of torch tensors; the reference's
``restore(shardings=)`` is ``restore(device=)`` here).  No JAX.
"""
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import RunHealth
from repro_torch.runtime import FaultPlan, FaultSpec, faults
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import resume_or_init


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    faults.clear()
    yield
    faults.clear()


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.as_tensor(rng.normal(size=(4, 3)), dtype=torch.float32),
        "nested": {"b": torch.as_tensor(rng.integers(0, 9, (2,)),
                                        dtype=torch.int32)},
    }


def _like(t):
    return {"a": ckpt.LeafSpec((4, 3), np.float32),
            "nested": {"b": ckpt.LeafSpec((2,), np.int32)}}


def _assert_tree_equal(x, y):
    lx, dx = ckpt.tree_flatten(x)
    ly, dy = ckpt.tree_flatten(y)
    assert dx == dy
    for a, b in zip(lx, ly):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 3, t, extra={"data_step": 4})
    got, extra, step = ckpt.restore(tmp_path, _like(t))
    assert step == 3 and extra == {"data_step": 4}
    _assert_tree_equal(t, got)
    assert got["a"].dtype == torch.float32
    assert got["nested"]["b"].dtype == torch.int32


def test_partial_write_is_ignored(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    # forge a later, uncommitted (crashed) checkpoint
    bad = tmp_path / "step_00000002"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ckpt.latest_step(tmp_path) == 1
    got, _, step = ckpt.restore(tmp_path, _like(t))
    assert step == 1
    _assert_tree_equal(t, got)


def _crash_save(root, step, tree, *, crash_after):
    """Replay `ckpt.save`'s write sequence and die at a chosen point.

    crash_after="tmp": after the tmp-dir write, before the rename;
    crash_after="rename": after the rename but before COMMIT.
    """
    root = Path(root)
    tmp = root / f"step_{step:08d}.tmp"
    tmp.mkdir(parents=True)
    leaves, _ = ckpt.tree_flatten(tree)
    for i, leaf in enumerate(leaves):
        np.save(tmp / f"arr_{i:05d}.npy", leaf.numpy())
    (tmp / "manifest.json").write_text(json.dumps({
        "step": step, "treedef": "crashed", "n_leaves": len(leaves),
        "extra": {}, "leaves": [
            {"shape": list(x.shape), "dtype": str(x.numpy().dtype)}
            for x in leaves]}))
    if crash_after == "tmp":
        return tmp
    final = root / f"step_{step:08d}"
    tmp.rename(final)
    return final  # crashed before COMMIT


def test_crash_between_tmp_write_and_commit(tmp_path):
    """A kill anywhere in the save window never corrupts the last COMMIT,
    and the abandoned tmp dir is swept by the next save once stale."""
    t = _tree()
    ckpt.save(tmp_path, 1, t, extra={"cursor": 11})
    junk_tmp = _crash_save(tmp_path, 2, _tree(9), crash_after="tmp")
    _crash_save(tmp_path, 3, _tree(9), crash_after="rename")

    assert ckpt.latest_step(tmp_path) == 1
    got, extra, step = ckpt.restore(tmp_path, _like(t))
    assert step == 1 and extra == {"cursor": 11}
    _assert_tree_equal(t, got)

    old = time.time() - 3600
    os.utime(junk_tmp, (old, old))
    ckpt.save(tmp_path, 4, t)
    assert not junk_tmp.exists()
    assert ckpt.latest_step(tmp_path) == 4


def test_fresh_tmp_dir_survives_sweep(tmp_path):
    t = _tree()
    live_tmp = _crash_save(tmp_path, 7, t, crash_after="tmp")
    ckpt.save(tmp_path, 8, t)
    assert live_tmp.exists()


def test_extra_validation():
    assert ckpt.validate_extra(None) == {}
    assert ckpt.validate_extra({"cursor": (1, 2)}) == {"cursor": [1, 2]}
    with pytest.raises(TypeError, match="extra\\['bad'\\]"):
        ckpt.validate_extra({"bad": np.zeros(3)})
    with pytest.raises(TypeError, match="dict"):
        ckpt.validate_extra([1, 2])


def test_save_rejects_bad_extra_before_writing(tmp_path):
    with pytest.raises(TypeError):
        ckpt.save(tmp_path, 0, _tree(), extra={"arr": np.zeros(2)})
    assert list(tmp_path.glob("step_*")) == []


def test_retention(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(tmp_path, s, t, keep_last=2)
    committed = sorted(p.name for p in tmp_path.glob("step_*")
                       if (p / "COMMIT").exists())
    assert committed == ["step_00000004", "step_00000005"]


def test_async_save(tmp_path):
    t = _tree()
    th = ckpt.save_async(tmp_path, 7, t)
    th.join()
    got, _, step = ckpt.restore(tmp_path, _like(t))
    assert step == 7
    _assert_tree_equal(t, got)


def test_async_save_copies_before_returning(tmp_path):
    """The port's metric states change in place: what `save_async` writes
    is the tree as it was when the call returned."""
    t = _tree()
    want = {"a": t["a"].clone(), "nested": {"b": t["nested"]["b"].clone()}}
    th = ckpt.save_async(tmp_path, 0, t)
    t["a"].add_(1.0)
    t["nested"]["b"].zero_()
    th.join()
    got, _, _ = ckpt.restore(tmp_path, _like(t))
    _assert_tree_equal(want, got)


def test_resume_or_init(tmp_path):
    t = _tree(5)
    got, extra, start = resume_or_init(tmp_path, lambda: t, _like(t))
    assert start == 0
    ckpt.save(tmp_path, 9, t, extra={"data_step": 10})
    got, extra, start = resume_or_init(tmp_path, lambda: _tree(1), _like(t))
    assert start == 10
    _assert_tree_equal(t, got)


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 0, _tree())
    wrong = {"a": ckpt.LeafSpec((5, 3), np.float32),
             "nested": {"b": ckpt.LeafSpec((2,), np.int32)}}
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, wrong)


def test_crc_mismatch_raises_corrupt_error(tmp_path):
    t = _tree()
    final = ckpt.save(tmp_path, 0, t)
    f = sorted(final.glob("arr_*.npy"))[0]
    data = bytearray(f.read_bytes())
    data[-1] ^= 0x01  # payload byte, past the .npy header
    f.write_bytes(bytes(data))
    with pytest.raises(ckpt.CorruptCheckpointError, match="CRC mismatch"):
        ckpt.restore(tmp_path, _like(t))
    got, _, step = ckpt.restore(tmp_path, _like(t), verify=False)
    assert step == 0


def test_v1_manifest_restores_unverified(tmp_path):
    t = _tree()
    final = ckpt.save(tmp_path, 0, t)
    mpath = final / "manifest.json"
    m = json.loads(mpath.read_text())
    m.pop("format_version", None)
    for leaf in m["leaves"]:
        leaf.pop("crc32", None)
    mpath.write_text(json.dumps(m))
    got, _, step = ckpt.restore(tmp_path, _like(t))
    assert step == 0
    _assert_tree_equal(t, got)


def test_unreadable_manifest_raises_corrupt_error(tmp_path):
    t = _tree()
    final = ckpt.save(tmp_path, 0, t)
    (final / "manifest.json").write_text('{"half": tru')
    with pytest.raises(ckpt.CorruptCheckpointError, match="manifest"):
        ckpt.restore(tmp_path, _like(t))


def test_async_save_error_surfaces(tmp_path):
    """A failing background save re-raises from `wait_pending` and from
    the next save call, never dying silently with its thread."""
    (tmp_path / "blocker").write_text("i am a file, not a directory")
    bad_root = tmp_path / "blocker" / "ckpt"  # mkdir → ENOTDIR
    t = _tree()
    th = ckpt.save_async(bad_root, 0, t)
    th.join()
    with pytest.raises(OSError):
        ckpt.wait_pending()
    assert ckpt.wait_pending() == []
    ckpt.save(tmp_path / "ok", 1, t)

    ckpt.save_async(bad_root, 2, t).join()
    with pytest.raises(OSError):
        ckpt.save(tmp_path / "ok", 3, t)
    assert ckpt.wait_pending(raise_errors=False) == []


def test_wait_pending_collects_without_raising(tmp_path):
    (tmp_path / "blocker").write_text("x")
    bad_root = tmp_path / "blocker" / "ckpt"
    ckpt.save_async(bad_root, 0, _tree()).join()
    errs = ckpt.wait_pending(raise_errors=False)
    assert len(errs) == 1 and isinstance(errs[0], OSError)


def test_transient_io_error_is_retried(tmp_path):
    """Injected EIO on the first two attempts: the third succeeds, each
    retry lands in RunHealth; past the budget, or for a non-transient
    errno, the error propagates."""
    t = _tree()
    health = RunHealth()
    faults.install(FaultPlan(
        [FaultSpec("save.io", "io_error", at=1, times=2, errno_name="EIO")]))
    ckpt.save(tmp_path, 0, t, retries=2, retry_backoff_s=0.0, health=health)
    faults.clear()
    assert ckpt.latest_step(tmp_path) == 0
    assert health.count("save_retry") == 2

    faults.install(FaultPlan(
        [FaultSpec("save.io", "io_error", at=1, times=99,
                   errno_name="ENOSPC")]))
    with pytest.raises(OSError):
        ckpt.save(tmp_path, 1, t, retries=2, retry_backoff_s=0.0)
    faults.install(FaultPlan(
        [FaultSpec("save.io", "io_error", at=1, errno_name="EACCES")]))
    health2 = RunHealth()
    with pytest.raises(PermissionError):
        ckpt.save(tmp_path, 2, t, retries=2, retry_backoff_s=0.0,
                  health=health2)
    assert health2.count("save_retry") == 0


def test_stale_ttl_configurable(tmp_path, monkeypatch):
    """The abandoned-tmp sweep TTL: the argument, then
    $REPRO_TORCH_STALE_TMP_S, then 60 s."""
    assert ckpt.STALE_TMP_ENV == "REPRO_TORCH_STALE_TMP_S"
    monkeypatch.delenv(ckpt.STALE_TMP_ENV, raising=False)
    t = _tree()
    junk = _crash_save(tmp_path, 5, t, crash_after="tmp")
    old = time.time() - 10
    os.utime(junk, (old, old))
    ckpt.save(tmp_path, 6, t)
    assert junk.exists()
    ckpt.save(tmp_path, 7, t, stale_tmp_s=5.0)
    assert not junk.exists()
    junk2 = _crash_save(tmp_path, 8, t, crash_after="tmp")
    os.utime(junk2, (old, old))
    monkeypatch.setenv(ckpt.STALE_TMP_ENV, "5")
    ckpt.save(tmp_path, 9, t)
    assert not junk2.exists()


def test_sweep_never_touches_this_process_live_tmp(tmp_path):
    t = _tree()
    live = _crash_save(tmp_path, 5, t, crash_after="tmp")
    old = time.time() - 3600
    os.utime(live, (old, old))
    with ckpt._ACTIVE_LOCK:
        ckpt._ACTIVE_TMP.add(live)
    try:
        ckpt.save(tmp_path, 6, t, stale_tmp_s=0.0)
        assert live.exists()
    finally:
        with ckpt._ACTIVE_LOCK:
            ckpt._ACTIVE_TMP.discard(live)
    ckpt.save(tmp_path, 7, t, stale_tmp_s=0.0)
    assert not live.exists()


def test_committed_steps_ascending(tmp_path):
    t = _tree()
    for s in (4, 1, 9):
        ckpt.save(tmp_path, s, t, keep_last=10)
    _crash_save(tmp_path, 12, t, crash_after="rename")  # no COMMIT
    assert ckpt.committed_steps(tmp_path) == [1, 4, 9]


def test_restore_with_device(tmp_path):
    """`restore(device=)` places every leaf (the reference's shardings)."""
    t = _tree()
    ckpt.save(tmp_path, 0, t)
    got, _, _ = ckpt.restore(tmp_path, _like(t), device="cpu")
    _assert_tree_equal(t, got)
    assert all(x.device.type == "cpu" for x in ckpt.tree_flatten(got)[0])
    meta, _, _ = ckpt.restore(tmp_path, _like(t), device="meta")
    assert all(x.device.type == "meta" for x in ckpt.tree_flatten(meta)[0])


def test_tree_flatten_roundtrip_and_uint32():
    """Lists, tuples, dicts (sorted keys) and None round-trip; a uint32
    leaf (the mIS bitmap's stored dtype) restores with its bits."""
    tree = {"z": [np.arange(3, dtype=np.uint32), (torch.ones(2), None)],
            "a": 7}
    leaves, d = ckpt.tree_flatten(tree)
    assert [np.asarray(x).tolist() for x in leaves] == [7, [0, 1, 2],
                                                        [1.0, 1.0]]
    back = ckpt.tree_unflatten(d, leaves)
    assert back["z"][1][1] is None and isinstance(back["z"][1], tuple)


def test_uint32_leaf_roundtrip(tmp_path):
    words = np.array([0, 1, 2**31, 2**32 - 1], np.uint32)
    ckpt.save(tmp_path, 0, [words])
    got, _, _ = ckpt.restore(tmp_path, [ckpt.LeafSpec((4,), np.uint32)])
    assert got[0].numpy().dtype == np.uint32
    np.testing.assert_array_equal(got[0].numpy(), words)
