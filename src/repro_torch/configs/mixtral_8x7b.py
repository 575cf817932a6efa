"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
(arXiv:2401.04088; hf).

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, window=4096.
SWA keeps a rolling KV → long_500k runs (sub-quadratic decode).
``CONFIG`` and ``REDUCED`` are the reference's, minus ``use_flash``.
"""
from ..models.transformer import TransformerConfig
from .lm import LMArch

CONFIG = TransformerConfig(
    name="mixtral-8x7b",
    vocab=32_000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    window=4096,
    attn_impl="chunked",
    remat=True,
)

REDUCED = TransformerConfig(
    name="mixtral-reduced",
    vocab=512,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=0,
    n_experts=4,
    top_k=2,
    moe_d_ff=32,
    window=16,
    attn_impl="dense",
    remat=False,
)

ARCH = LMArch("mixtral-8x7b", CONFIG, REDUCED, sub_quadratic=True)
