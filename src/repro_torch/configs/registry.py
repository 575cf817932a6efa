"""Arch registry: ``--arch <id>`` resolution for the port's launchers.

Resolves the archs the port can run now; every other arch of the
reference's registry raises `NotImplementedError` (ROADMAP.md)."""
from __future__ import annotations

import importlib
from typing import List, Optional

# arch id → (module, family)
_ARCH_MODULES = {
    "qwen3-1.7b": (".qwen3_1_7b", "lm"),
    "dlrm-rm2": (".dlrm_rm2", "recsys"),
    "graphsage-reddit": (".graphsage_reddit", "gnn"),
}
# the reference's other archs, waiting for their layers or configs
_NOT_PORTED = (
    "minitron-4b", "gemma2-27b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
    "schnet", "nequip", "graphcast",
)


def list_archs(family: Optional[str] = None) -> List[str]:
    """The ported archs, or those of one family (lm, recsys, gnn)."""
    return [name for name, (_, fam) in _ARCH_MODULES.items()
            if family in (None, fam)]


def get_arch(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; see ROADMAP.md (ported: "
            f"{list_archs()})")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(_ARCH_MODULES[name][0], package=__package__)
    return mod.ARCH
