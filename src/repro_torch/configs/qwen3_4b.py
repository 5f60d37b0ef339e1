"""qwen3-4b [dense]: 36L, d=2560, 32H (GQA kv=8), d_ff=9728, vocab=151936.
qk-norm, GQA, full attention. [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ArchConfig, GLOBAL

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    d_model=2560,
    num_layers=36,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    block_pattern=(GLOBAL,),
    qk_norm=True,
    act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    supports_long_context=False,    # pure full attention -> skip long_500k
    source="hf:Qwen/Qwen3-8B; hf",
)
