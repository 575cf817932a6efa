"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each source under ``repro_torch/csrc/`` is compiled on first use by its own
``nvcc`` process for ``sm_90a`` into a shared library with a plain C
interface, which is loaded with ``ctypes``.  No source includes PyTorch's
headers: the wrappers pass raw device pointers (``tensor.data_ptr()``) and
PyTorch's current stream, so a build takes seconds, not minutes.

Libraries land in ``build/repro_torch_ext/`` under the repository root
(``$REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the source and
flags, so an edited source rebuilds and an unchanged one is reused.
`build_all` starts one ``nvcc`` per source, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "build_all", "load_library", "build_dir", "ptxas_report"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "frontier_expand": CSRC / "frontier_expand.cu",
    "mis_bitmap": CSRC / "mis_bitmap.cu",
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
