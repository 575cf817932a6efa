"""minitron-4b [dense] — pruned Nemotron (arXiv:2407.14679; hf).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000. Pure full attention
→ long_500k is a documented skip.  ``CONFIG`` and ``REDUCED`` are the
reference's, minus ``use_flash``.
"""
from ..models.transformer import TransformerConfig
from .lm import LMArch

CONFIG = TransformerConfig(
    name="minitron-4b",
    vocab=256_000,
    d_model=3072,
    n_layers=32,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    attn_impl="chunked",
    remat=True,
)

REDUCED = TransformerConfig(
    name="minitron-4b-reduced",
    vocab=512,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    attn_impl="dense",
    remat=False,
)

ARCH = LMArch("minitron-4b", CONFIG, REDUCED, sub_quadratic=False)
