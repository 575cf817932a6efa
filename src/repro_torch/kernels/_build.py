"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each source under ``repro_torch/csrc/`` is compiled on first use by its own
``nvcc`` process for ``sm_90a`` into a shared library with a plain C
interface, which is loaded with ``ctypes``.  No source includes PyTorch's
headers: the wrappers pass raw device pointers (``tensor.data_ptr()``) and
PyTorch's current stream, so a build takes seconds, not minutes.

Libraries land in ``build/repro_torch_ext/`` under the repository root
(``$REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the source and
flags, so an edited source rebuilds and an unchanged one is reused.
`build_all` starts one ``nvcc`` per source, all together.  Every CUDA
kernel of a source is named with that source's prefix (`KERNEL_PREFIX`), so
a profile can sum a port kernel's device time over all its launches
(`kernel_source`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["SOURCES", "KERNEL_PREFIX", "build_all", "load_library",
           "build_dir", "ptxas_report", "library_path", "kernel_function",
           "kernel_source"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "frontier_expand": CSRC / "frontier_expand.cu",
    "mis_bitmap": CSRC / "mis_bitmap.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "embedding_bag": CSRC / "embedding_bag.cu",
    "gather_aggregate": CSRC / "gather_aggregate.cu",
}
# the name prefix of every CUDA kernel (`__global__` function) of a source
KERNEL_PREFIX = {
    "frontier_expand": "frontier_",
    "mis_bitmap": "mis_",
    "flash_attention": "flash_attn_",
    "embedding_bag": "bag_",
    "gather_aggregate": "agg_",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}_{h}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the process."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, log = started
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name} (rc={rc}):\n"
                           + out.with_suffix(".log").read_text())
    os.replace(tmp, out)


def build_all(names: List[str] = None) -> None:
    """Compile every kernel library not built yet, one nvcc each, in parallel."""
    names = list(SOURCES) if names is None else names
    started = {name: _start(name) for name in names}
    for name, s in started.items():
        _finish(name, s)


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    return _target(name)


def kernel_function(key: str) -> str:
    """The function name of a CUDA kernel as a profiler names it
    ('void ns::f<T>(args)' → 'f'); other keys unchanged."""
    m = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
    return m.group(1) if m else key


def kernel_source(key: str) -> Optional[str]:
    """The source (a key of `SOURCES`) whose CUDA kernel a profiler's
    kernel name ``key`` is, or None for a kernel not of the port."""
    fn = kernel_function(key)
    for name, prefix in KERNEL_PREFIX.items():
        if fn.startswith(prefix):
            return name
    return None


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report of the last build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib
