"""gemma3-27b [dense]: 62L, d=5376, 32H (GQA kv=16), d_ff=21504,
vocab=262144.  5:1 local:global attention, 128k context, qk-norm.
[hf:google/gemma-3-1b-pt scaled per assignment; unverified]
"""
from .base import ArchConfig, GLOBAL, LOCAL

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    num_layers=62,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    # 62 = 2 unrolled local + 10 x (5 local + 1 global)
    prefix_layers=(LOCAL, LOCAL),
    block_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),
    window=1024,
    qk_norm=True,
    act="gelu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    supports_long_context=True,     # 5:1 local dominates; global KV sharded
    source="hf:google/gemma-3-1b-pt; unverified",
)
