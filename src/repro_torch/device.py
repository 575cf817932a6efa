"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and runs on ``"cuda"`` unless
the caller asks for the CPU.  Asking for CUDA where there is no card raises:
the port never carries on on the CPU in its place.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
