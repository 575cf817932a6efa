"""Public wrapper: drop-in replacement for `core.mis.mis_greedy_update`.

CUDA tensors launch the kernel (``kernel.py``); CPU tensors take the plain
version (``ref.py``); any other device raises.  There is no fallback from
the kernel to the plain version.
"""
from __future__ import annotations

from .kernel import mis_bitmap_select
from .ref import mis_bitmap_ref


def mis_greedy_update_kernel(bitmap, count, emb, n_valid, tau, k: int):
    """Same signature/result as repro_torch.core.mis.mis_greedy_update."""
    if emb.device.type == "cpu":
        return mis_bitmap_ref(bitmap, count, emb, n_valid, tau, k)
    if emb.device.type != "cuda":
        raise ValueError(f"mis_greedy_update_kernel: no kernel for {emb.device}")
    return mis_bitmap_select(bitmap.contiguous(), count.contiguous(),
                             emb.contiguous(), n_valid.contiguous(),
                             tau.contiguous(), k=k)
