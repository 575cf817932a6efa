"""Arch registry: ``--arch <id>`` resolution for the port's launchers.

Resolves the archs the port can run now; every other arch of the
reference's registry raises `NotImplementedError` (ROADMAP.md)."""
from __future__ import annotations

import importlib
from typing import List

_ARCH_MODULES = {
    "qwen3-1.7b": ".qwen3_1_7b",
}
# the reference's other archs, waiting for their layers or configs
_NOT_PORTED = (
    "minitron-4b", "gemma2-27b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
    "graphsage-reddit", "schnet", "nequip", "graphcast", "dlrm-rm2",
)


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_arch(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; see ROADMAP.md (ported: "
            f"{list_archs()})")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(_ARCH_MODULES[name], package=__package__)
    return mod.ARCH
