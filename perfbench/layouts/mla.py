"""DeepSeek-V2's Multi-head Latent Attention (arXiv:2405.04434), as the
program's ``models/attention.py::init_attn`` defines it for an MLA arch:
a query of ``qk_nope_dim`` + ``qk_rope_dim`` a head straight from x (no
query LoRA); a latent of ``kv_lora_rank`` and one RoPE key shared by the
heads from ``w_dkv``, the latent RMS-normed by ``kv_norm``; keys' nope
part and the values (``v_head_dim``) from the latent by ``w_ukv``.

The work is counted in this decompressed form, whatever form the program
runs it in.  Its prefill runs the flash kernel on decompressed keys and
values (and decompresses the cached latent again); its decode attends in
the latent space, ``w_ukv``'s key part absorbed into the query and its
value part applied after, which takes the same projection work a token
and, where ``kv_lora_rank`` is at least ``qk_nope_dim`` and
``v_head_dim`` (DeepSeek-V2 and V3: 512 against 128), more attention work
a key than this count: 2 (r + rd) + 2 r against 2 (nd + rd) + 2 vd FLOPs
a head.  The same work is counted whatever implements it, so a program
that changes the form moves its time and not its count, and an MFU of
either form reads low, never past 100 %."""
from __future__ import annotations

from typing import List

from work.kernels import attended_pairs

from . import Leaf, mlp_leaves, mlp_matmul_params

ARCH_KEYS = ("kv_lora_rank", "qk_rope_dim", "qk_nope_dim", "v_head_dim")
ARCH_FIXED = {"mla": True}


def _sizes(cfg: dict) -> tuple:
    return (cfg["d_model"], cfg["num_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_dim"], cfg["qk_rope_dim"], cfg["v_head_dim"])


def layer_leaves(cfg: dict, li: int) -> List[Leaf]:
    """RMSNorm weights, the MLA projections and ``kv_norm``, then the
    MLP."""
    d, h, r, nd, rd, vd = _sizes(cfg)
    return [Leaf("ln1", (d,), None),
            Leaf("mixer.wq", (d, h * (nd + rd)), d ** -0.5),
            Leaf("mixer.w_dkv", (d, r + rd), d ** -0.5),
            Leaf("mixer.kv_norm", (r,), None),
            Leaf("mixer.w_ukv", (r, h * (nd + vd)), r ** -0.5),
            Leaf("mixer.wo", (h * vd, d), (h * vd) ** -0.5),
            Leaf("ln2", (d,), None)] + mlp_leaves(cfg, li)


def layer_matmul_params(cfg: dict, li: int) -> int:
    """q, the latent and RoPE key, each token's latent decompressed once
    into its key and value heads, the output; then the MLP."""
    d, h, r, nd, rd, vd = _sizes(cfg)
    return (d * h * (nd + rd) + d * (r + rd) + r * h * (nd + vd)
            + h * vd * d + mlp_matmul_params(cfg, li))


def attention_flops(cfg: dict, b: int, s: int, t: int, q_start: int = 0
                    ) -> float:
    """2 a multiply-add of q.k over nope + rope dims and of p.v over
    ``v_head_dim``, a pair and head."""
    _, h, _, nd, rd, vd = _sizes(cfg)
    pairs = b * attended_pairs(s, t, True, 0, q_start)
    return float(cfg["num_layers"] * 2 * pairs * h * (nd + rd + vd))


def attn_shape(cfg: dict) -> tuple:
    _, h, _, nd, rd, vd = _sizes(cfg)
    return h, h, nd + rd, vd
