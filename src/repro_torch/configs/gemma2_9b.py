"""gemma2-9b [dense]: 42L, d=3584, 16H (GQA kv=8), d_ff=14336, vocab=256000.
Local+global alternating attention, logit softcapping. [arXiv:2408.00118; hf]
"""
from .base import ArchConfig, GLOBAL, LOCAL

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    d_model=3584,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    block_pattern=(LOCAL, GLOBAL),  # 1:1 alternation
    window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    supports_long_context=True,     # half the layers are window-bounded
    source="arXiv:2408.00118; hf",
)
