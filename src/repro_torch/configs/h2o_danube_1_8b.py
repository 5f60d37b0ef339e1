"""h2o-danube-1.8b [dense]: 24L, d=2560, 32H (GQA kv=8), d_ff=6912,
vocab=32000.  Llama+Mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]
"""
from .base import ArchConfig, LOCAL

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    d_model=2560,
    num_layers=24,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    block_pattern=(LOCAL,),        # SWA on every layer (mistral-style)
    window=4096,
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    supports_long_context=True,    # SWA -> KV bounded by window
    source="arXiv:2401.16818; hf",
)
