"""Model zoo of the port — so far the dense decoder-only transformer that
the serving path runs (``repro.models`` on PyTorch)."""
