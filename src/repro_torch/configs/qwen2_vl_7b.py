"""qwen2-vl-7b [vlm]: 28L, d=3584, 28H (GQA kv=4), d_ff=18944, vocab=152064.
M-RoPE (t/h/w sections), dynamic resolution. [arXiv:2409.12191; hf]

The vision frontend (ViT patch encoder) is a STUB: ``input_specs`` provides
precomputed patch embeddings placed as a vision prefix in the sequence,
plus the 3-stream M-RoPE position ids.
"""
from .base import ArchConfig, GLOBAL

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    d_model=3584,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    block_pattern=(GLOBAL,),
    mrope_sections=(16, 24, 24),   # half-dims per (t, h, w); sum = head_dim/2
    act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    supports_long_context=False,   # pure full attention -> skip long_500k
    source="arXiv:2409.12191; hf",
    notes="vision patch frontend stubbed to precomputed patch embeddings",
)
