"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained d_ff=768
(hf:Qwen/Qwen3-30B-A3B; hf).

48L d_model=2048 32H (GQA kv=4) vocab=151936. Pure full attention →
long_500k is a documented skip.  ``CONFIG`` and ``REDUCED`` are the
reference's, minus ``use_flash``.
"""
from ..models.transformer import TransformerConfig
from .lm import LMArch

CONFIG = TransformerConfig(
    name="qwen3-moe-30b-a3b",
    vocab=151_936,
    d_model=2048,
    n_layers=48,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_base=1_000_000.0,
    attn_impl="chunked",
    remat=True,
)

REDUCED = TransformerConfig(
    name="qwen3-moe-reduced",
    vocab=512,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=0,
    n_experts=8,
    top_k=2,
    moe_d_ff=32,
    qk_norm=True,
    attn_impl="dense",
    remat=False,
)

ARCH = LMArch("qwen3-moe-30b-a3b", CONFIG, REDUCED, sub_quadratic=False)
