"""deepseek-moe-16b [moe]: 28L, d=2048, 16H (GQA kv=16), expert d_ff=1408,
vocab=102400.  Fine-grained MoE: 2 shared + 64 routed, top-6; first layer
dense. [arXiv:2401.06066; hf]
"""
from .base import ArchConfig, LayerSpec, GLOBAL

_MOE = LayerSpec(mixer="attn", mlp="moe")

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    d_model=2048,
    num_layers=28,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                    # the single dense layer's FFN width
    vocab_size=102400,
    prefix_layers=(GLOBAL,),       # layer 0 is dense
    block_pattern=(_MOE,),
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    supports_long_context=False,   # full attention -> skip long_500k
    source="arXiv:2401.06066; hf",
)
