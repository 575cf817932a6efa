"""Greedy mIS selection over a packed bitmap as a CUDA kernel (see ``kernel.py``)."""
