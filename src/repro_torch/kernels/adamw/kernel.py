"""Binding of the fused AdamW kernel (``csrc/adamw.cu``).

Replaces no TPU kernel (the reference's update is ``jnp`` that XLA
fuses): one pass over a parameter, its gradient and moments, equal bit
for bit to the plain version (``ref.py``).  The library is built on first
use (`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import load_library

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _lib():
    lib = load_library("adamw")
    if lib.adamw_launch.argtypes is None:
        lib.adamw_launch.argtypes = [_P, _P, _P, _P, _L, _P, _F, _F, _F, _F,
                                     _F, _F, _I, _I, _P]
        lib.adamw_launch.restype = _I
    return lib


def _f32(x: float) -> float:
    """The f32 value PyTorch uses for a Python number in an f32 op."""
    return float(np.float32(x))


def adamw_fused(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, scalars: torch.Tensor, cfg) -> None:
    """Update p, m and v (contiguous f32 CUDA tensors of one shape) in
    place from g (the same); ``scalars`` is (4,) f32 on the same device:
    clip scale, lr, 1 − b1^t, 1 − b2^t."""
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != p.shape
                or t.device != p.device):
            raise ValueError(
                f"{name}: need a contiguous float32 CUDA tensor of shape "
                f"{tuple(p.shape)} on {p.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if (scalars.device != p.device or scalars.dtype != torch.float32
            or scalars.shape != (4,) or not scalars.is_contiguous()):
        raise ValueError("scalars: need (4,) float32 on the parameters' device")
    n = p.numel()
    if n == 0:
        return
    vec4 = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (p, g, m, v))
    lib = _lib()
    dev = p.device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adamw_launch(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
            scalars.data_ptr(), _f32(cfg.b1), _f32(1 - cfg.b1), _f32(cfg.b2),
            _f32(1 - cfg.b2), _f32(cfg.eps), _f32(cfg.weight_decay),
            int(vec4), sms, stream)
    if err != 0:
        raise RuntimeError(f"adamw launch failed: CUDA error {err}")
    adamw_fused.launches += 1


adamw_fused.launches = 0
