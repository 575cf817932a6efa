"""dlrm-rm2 [recsys] — 13 dense / 26 sparse / embed 64 / dot interaction
(arXiv:1906.00091; paper)."""
from .recsys import CONFIG, REDUCED, RecsysArch

ARCH = RecsysArch("dlrm-rm2", CONFIG, REDUCED)
