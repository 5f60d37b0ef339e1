"""Model FLOPs of the benchmark's steps, counted from the configuration
file's sizes: 2 a multiply-add of every matmul the step runs on a token
(the embedding is a lookup and is not counted; an MoE layer counts its
router, its top-k experts and its shared experts: the routed work of a
pair the capacity drops is counted too) and the attention's scores and
values over the pairs the causal mask lets through.  Training counts 3
times the forward (the backward twice), recomputation not counted."""
from __future__ import annotations

from .kernels import attended_pairs


def layer_matmul_params(cfg: dict, li: int) -> int:
    """Weights a token multiplies by in layer ``li`` (the active ones of
    an MoE layer)."""
    d, h, kv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["head_dim"])
    attn = d * h * hd * 2 + d * kv * hd * 2
    if cfg.get("num_experts", 0) and li >= cfg.get("first_dense_layers", 0):
        f = cfg["moe_d_ff"]
        mlp = (d * cfg["num_experts"]
               + (cfg["top_k"] + cfg["num_shared_experts"]) * 3 * d * f)
    else:
        mlp = 3 * d * cfg["d_ff"]
    return attn + mlp


def body_params(cfg: dict) -> int:
    return sum(layer_matmul_params(cfg, li) for li in range(cfg["num_layers"]))


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def attention_flops(cfg: dict, b: int, s: int, t: int, q_start: int = 0
                    ) -> float:
    """Scores and values of every layer over b rows of s queries (from
    position ``q_start``) against t keys, causal."""
    pairs = b * cfg["num_heads"] * attended_pairs(s, t, True, 0, q_start)
    return float(cfg["num_layers"] * 4 * pairs * cfg["head_dim"])


def prefill_flops(cfg: dict, b: int, s: int) -> float:
    """A prefill of b prompts of s tokens: the logits of the last token
    of each only."""
    return (2.0 * b * s * body_params(cfg) + 2.0 * b * head_params(cfg)
            + attention_flops(cfg, b, s, s))


def decode_flops(cfg: dict, b: int, pos: int) -> float:
    """One decode step of b rows at position ``pos`` (pos + 1 keys)."""
    return (2.0 * b * (body_params(cfg) + head_params(cfg))
            + attention_flops(cfg, b, 1, pos + 1, q_start=pos))


def train_flops(cfg: dict, b: int, s: int) -> float:
    """One training step on b sequences of s tokens."""
    return 3.0 * (2.0 * b * s * (body_params(cfg) + head_params(cfg))
                  + attention_flops(cfg, b, s, s))
