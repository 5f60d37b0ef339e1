"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d=1024, 16H (GQA kv=16),
d_ff=4096, vocab=256206.  Encoder-decoder, multimodal. [arXiv:2308.11596; hf]

The speech frontend (conformer feature extractor) is a STUB: ``input_specs``
provides precomputed frame embeddings of shape (batch, enc_len, d_model).
"""
from .base import ArchConfig, GLOBAL

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    num_layers=12,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    block_pattern=(GLOBAL,),
    encoder_layers=12,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    supports_long_context=False,   # full attention -> skip long_500k
    source="arXiv:2308.11596; hf",
    notes="enc-dec; audio frontend stubbed to precomputed frame embeddings",
)
