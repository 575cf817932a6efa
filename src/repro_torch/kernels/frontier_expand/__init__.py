"""One whole match-expansion level as a CUDA kernel (see ``kernel.py``)."""
