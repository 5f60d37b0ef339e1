"""mamba2-780m [ssm]: 48L, d=1536, attn-free, vocab=50280, ssm_state=128.
SSD (state-space duality). [arXiv:2405.21060; unverified]

Morpheus arch-applicability (DESIGN.md): decode state is O(1); there is no
KV working set to extend, so the Morpheus tier is disabled by default for
this arch (it can still cache embedding/lm-head pages).
"""
from .base import ArchConfig, MAMBA

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    d_model=1536,
    num_layers=48,
    num_heads=1,                   # unused (attn-free)
    num_kv_heads=1,
    d_ff=0,                        # mamba blocks have no separate MLP
    vocab_size=50280,
    block_pattern=(MAMBA,),
    d_inner=3072,                  # 2 * d_model
    ssm_state=128,
    ssm_head_dim=64,               # 48 SSD heads
    ssm_groups=1,
    tie_embeddings=True,
    # §Perf iteration 4: save dot/einsum outputs in the backward pass
    # (-19% HLO FLOPs, -2% HBM bytes vs full recompute at this scale)
    remat_policy="dots",
    morpheus_enabled=False,
    supports_long_context=True,    # O(1) state -> run long_500k
    source="arXiv:2405.21060; unverified",
)
