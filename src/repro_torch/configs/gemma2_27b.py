"""gemma2-27b [dense] — local+global alternating, logit softcap
(arXiv:2408.00118; hf).

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000. Local layers keep
a 4096-token rolling KV → long_500k runs (hybrid local/global).
``CONFIG`` and ``REDUCED`` are the reference's, minus ``use_flash``.
"""
from ..models.transformer import TransformerConfig
from .lm import LMArch

CONFIG = TransformerConfig(
    name="gemma2-27b",
    vocab=256_000,
    d_model=4608,
    n_layers=46,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    local_global=True,
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_impl="chunked",
    remat=True,
)

REDUCED = TransformerConfig(
    name="gemma2-27b-reduced",
    vocab=512,
    d_model=64,
    n_layers=4,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    local_global=True,
    window=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_impl="dense",
    remat=False,
)

ARCH = LMArch("gemma2-27b", CONFIG, REDUCED, sub_quadratic=True)
