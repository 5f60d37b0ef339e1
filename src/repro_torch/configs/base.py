"""Architecture configuration system.

Every assigned architecture is an ``ArchConfig``.  The layer stack is
described as a *repeating block pattern* plus an unrolled remainder — the
model builder scans over blocks (stacked params) so HLO size and compile
time stay bounded even for 62-layer models on 512-device meshes.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern."""
    mixer: str = "attn"          # "attn" | "mamba"
    attn_kind: str = "global"    # "global" | "local" (sliding window)
    mlp: str = "dense"           # "dense" | "moe"


GLOBAL = LayerSpec()
LOCAL = LayerSpec(attn_kind="local")
MAMBA = LayerSpec(mixer="mamba")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|encdec|vlm|audio
    d_model: int
    num_layers: int              # decoder layers (enc-dec: decoder side)
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[LayerSpec, ...] = (GLOBAL,)
    prefix_layers: Tuple[LayerSpec, ...] = ()   # unrolled layers BEFORE the scanned blocks
    head_dim: Optional[int] = None
    # attention variants
    window: int = 0              # sliding-window size for "local" layers
    logit_softcap: float = 0.0   # gemma2-style attn logit soft cap
    final_softcap: float = 0.0   # gemma2-style final logit soft cap
    qk_norm: bool = False        # qwen3-style per-head q/k RMSNorm
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    act: str = "silu"            # silu (swiglu) | gelu (geglu)
    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 SSD)
    d_inner: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    # encoder-decoder
    encoder_layers: int = 0
    # numerics / embeddings
    tie_embeddings: bool = True
    # NOTE on dtype (§Perf iteration 3, refuted-on-substrate): bf16
    # params/activations are the TPU production default and would halve the
    # HBM-byte and collective roofline terms.  The dry-run however compiles
    # on the CPU backend, whose float-normalization pass promotes every
    # bf16 compute op to f32 (verified: 1/82 dots stayed bf16), so the
    # measured terms for a bf16 config are the SAME graph plus convert
    # traffic — strictly worse numbers for a strictly better program.  We
    # therefore measure in f32 (matching what the CPU backend actually
    # lowers) and record the bf16 projection (bytes/2 on activation and
    # gradient traffic) in EXPERIMENTS.md instead of silently mixing the
    # two.  Archs whose public checkpoints are bf16 (gemma3, jamba) keep it.
    param_dtype: str = "float32"
    # remat policy for the scanned block ("full" | "dots"), see §Perf
    remat_policy: str = "full"
    # assignment metadata
    morpheus_enabled: bool = True
    supports_long_context: bool = False  # run long_500k? (sub-quadratic attn)
    source: str = ""
    notes: str = ""

    # ------------------------------------------------------------------ api
    def __post_init__(self):
        pat, pre = len(self.block_pattern), len(self.prefix_layers)
        assert pat > 0 and (self.num_layers - pre) % pat == 0, (
            f"{self.name}: {self.num_layers} layers != "
            f"{pre} + k*{pat}")

    @property
    def num_blocks(self) -> int:
        return (self.num_layers - len(self.prefix_layers)) // len(self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.d_inner else 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return -(-self.vocab_size // multiple) * multiple

    # -------------------------------------------------------- param counts
    def _mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if spec.mixer == "mamba":
            di, g, n = self.d_inner, self.ssm_groups, self.ssm_state
            in_proj = d * (2 * di + 2 * g * n + self.ssm_heads)
            conv = (di + 2 * g * n) * self.conv_width
            out = di * d
            extra = 2 * self.ssm_heads + di  # A, dt_bias, norm-ish
            return in_proj + conv + out + extra
        if self.mla:
            r, rd, nd, vd = (self.kv_lora_rank, self.qk_rope_dim,
                             self.qk_nope_dim, self.v_head_dim)
            h = self.num_heads
            q = d * h * (nd + rd)
            kv_down = d * (r + rd)
            kv_up = r * h * (nd + vd)
            o = h * vd * d
            return q + kv_down + kv_up + o
        h, kv = self.num_heads, self.num_kv_heads
        return d * hd * (h + 2 * kv) + h * hd * d

    def _mlp_params(self, spec: LayerSpec) -> Tuple[int, int]:
        """(total, active) params of the layer's MLP."""
        d = self.d_model
        if spec.mlp == "moe":
            e, k, sh, f = (self.num_experts, self.top_k,
                           self.num_shared_experts, self.moe_d_ff)
            router = d * e
            total = router + (e + sh) * 3 * d * f
            active = router + (k + sh) * 3 * d * f
            return total, active
        n_mats = 3  # swiglu / geglu
        return n_mats * d * self.d_ff, n_mats * d * self.d_ff

    def _layers(self) -> Tuple[LayerSpec, ...]:
        return self.prefix_layers + self.block_pattern * self.num_blocks

    def param_count(self) -> Tuple[int, int]:
        """(total, active) parameters, embeddings included."""
        total = active = 0
        enc_layers = (GLOBAL,) * self.encoder_layers
        for spec in self._layers() + enc_layers:
            m = self._mixer_params(spec)
            t, a = self._mlp_params(spec)
            total += m + t + 2 * self.d_model
            active += m + a + 2 * self.d_model
        if self.is_encdec:  # decoder cross-attention blocks
            x = self.num_layers * self._mixer_params(GLOBAL)
            total += x
            active += x
        emb = self.padded_vocab() * self.d_model
        emb *= 1 if self.tie_embeddings else 2
        total += emb
        active += emb
        return total, active

    # ---------------------------------------------------------- test utils
    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        pat, pre = len(self.block_pattern), len(self.prefix_layers)
        d = 64
        return replace(
            self,
            name=self.name + "-reduced",
            d_model=d,
            num_layers=pat + pre,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            window=min(self.window, 8) if self.window else 0,
            num_experts=8 if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=32 if self.moe_d_ff else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            d_inner=128 if self.d_inner else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.d_inner else 64,
            ssm_groups=min(self.ssm_groups, 2),
            encoder_layers=min(self.encoder_layers, 2),
            mrope_sections=(4, 2, 2) if self.mrope_sections else None,
            param_dtype="float32",
        )
