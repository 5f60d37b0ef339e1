from .adamw import AdamW, AdamWState, global_norm
from .grad_compression import CompressorState, Int8Compressor
from .schedule import constant, cosine_with_warmup

__all__ = ["AdamW", "AdamWState", "global_norm", "Int8Compressor",
           "CompressorState", "constant", "cosine_with_warmup"]
