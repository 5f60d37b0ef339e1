"""jamba-1.5-large-398b [hybrid]: 72L, d=8192, 64H (GQA kv=8), d_ff=24576,
vocab=65536, MoE 16 experts top-2.  Mamba+attention 1:7 interleave, MoE on
every other layer. [arXiv:2403.19887; hf]

Hardware-adaptation note (DESIGN.md): Jamba's SSM layers are Mamba-1; we
implement them with the Mamba-2 SSD (state-space duality) formulation —
the matmul-friendly, MXU-native algorithm — with state 128.
"""
from .base import ArchConfig, LayerSpec, GLOBAL, MAMBA

_M_DENSE = LayerSpec(mixer="mamba", mlp="dense")
_M_MOE = LayerSpec(mixer="mamba", mlp="moe")
_A_DENSE = LayerSpec(mixer="attn", mlp="dense")
_A_MOE = LayerSpec(mixer="attn", mlp="moe")

# Jamba block = 8 layers: attention at index 4, mamba elsewhere;
# MoE on odd layer indices (every other layer).  72 layers = 9 blocks.
_BLOCK = (_M_DENSE, _M_MOE, _M_DENSE, _M_MOE,
          _A_DENSE, _A_MOE, _M_DENSE, _M_MOE)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    num_layers=72,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=_BLOCK,
    head_dim=128,
    num_experts=16,
    top_k=2,
    num_shared_experts=0,
    moe_d_ff=24576,
    act="silu",
    rope_theta=10_000.0,          # jamba attn layers use no rope originally;
    #                               kept for uniformity (documented deviation)
    d_inner=16384,                # 2 * d_model
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=8,
    tie_embeddings=False,
    param_dtype="bfloat16",
    supports_long_context=True,   # SSM-dominated -> run long_500k
    source="arXiv:2403.19887; hf",
)
