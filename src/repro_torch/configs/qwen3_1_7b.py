"""qwen3-1.7b [dense] — qk_norm, GQA (hf:Qwen/Qwen3-8B family; hf).

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936. Pure full attention
→ long_500k is a documented skip.  ``CONFIG`` and ``REDUCED`` are the
reference's, minus ``use_flash``.
"""
from ..models.transformer import TransformerConfig
from .lm import LMArch

CONFIG = TransformerConfig(
    name="qwen3-1.7b",
    vocab=151_936,
    d_model=2048,
    n_layers=28,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    qk_norm=True,
    rope_base=1_000_000.0,
    attn_impl="chunked",
    remat=True,
)

REDUCED = TransformerConfig(
    name="qwen3-1.7b-reduced",
    vocab=512,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    qk_norm=True,
    attn_impl="dense",
    remat=False,
)

ARCH = LMArch("qwen3-1.7b", CONFIG, REDUCED, sub_quadratic=False)
