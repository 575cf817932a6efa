"""Hand-written CUDA kernels of the port, one package per TPU kernel replaced.

Each package follows the reference's ref / kernel / ops convention
(``docs/kernels.md``): ``ref.py`` is the plain torch version (the oracle),
``kernel.py`` binds the CUDA source under ``repro_torch/csrc/`` and counts
its launches, and ``ops.py`` is the drop-in the production code calls — the
kernel for CUDA tensors, the plain version for CPU tensors, and an error for
anything else.  Nothing here builds or imports a compiler at import time.
"""
