"""One computation for every worker of a pytest session.

The port's parity tests hold it against reference runs that cost tens of
seconds each (mostly the reference's JIT compiles).  A module-scoped
fixture runs once per *worker*, and pytest-xdist spreads one module's
tests over several workers, so such a fixture may run once for each of
them.  `shared_result` runs it once for the whole session: the first
worker computes under a file lock and pickles the value beside the
workers' temporary directories; the others wait on the lock and load it.
`SharedParts` splits one reference computation into named parts, each
shared so and computed when a test first reads one of its keys, so that a
test waits only for the parts it reads.  Used by the
``tests/test_torch_*.py`` fixtures; nothing in the package imports it.
"""
from __future__ import annotations

import fcntl
import os
import pickle
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, Sequence, Tuple

__all__ = ["shared_result", "SharedParts"]


def shared_result(tmp_path_factory, key: str,
                  compute: Callable[[Path], Any]) -> Any:
    """``compute(directory)`` once per pytest session, whatever the number
    of xdist workers; ``directory`` (shared by the workers) holds whatever
    files the value refers to.  The value must pickle."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / f"shared-{key}"
    d.mkdir(exist_ok=True)
    done = d / "result.pkl"
    with open(d / "lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if done.exists():
            return pickle.loads(done.read_bytes())
        work = d / "work"
        shutil.rmtree(work, ignore_errors=True)   # a failed worker's files
        work.mkdir()
        value = compute(work)
        tmp = d / "result.tmp"
        tmp.write_bytes(pickle.dumps(value))
        os.replace(tmp, done)
        return value


class SharedParts:
    """``ref[key]`` for a reference computation cut into parts: ``parts``
    maps a part's name to ``(keys, compute)``, where ``compute(ref)``
    returns a dict holding those keys and may read other parts' keys from
    ``ref``.  Each part is one `shared_result` (key ``"{key}-{name}"``),
    computed on the first read of one of its keys."""

    def __init__(self, tmp_path_factory, key: str,
                 parts: Dict[str, Tuple[Sequence[str], Callable]]):
        self._factory, self._key, self._parts = tmp_path_factory, key, parts
        self._values: Dict[str, dict] = {}

    def __getitem__(self, item: str) -> Any:
        for name, (keys, compute) in self._parts.items():
            if item in keys:
                if name not in self._values:
                    self._values[name] = shared_result(
                        self._factory, f"{self._key}-{name}",
                        lambda _: compute(self))
                return self._values[name][item]
        raise KeyError(item)
