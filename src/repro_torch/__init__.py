"""FLEXIS on PyTorch and CUDA — the port of the JAX package ``repro``.

Same layout and names as ``repro`` (``repro_torch.core.matcher`` ↔
``repro.core.matcher`` and so on).  Imports torch and numpy, never JAX and
nothing of ``repro``.  Entry points run on ``"cuda"`` unless the caller asks
for the CPU; the matcher's expansion level and the greedy-mIS update run as
hand-written CUDA kernels on the card (``repro_torch.kernels``).
"""
