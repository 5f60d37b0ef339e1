"""Grouped-query attention (multi-head where ``num_kv_heads`` equals
``num_heads``): ``wq``, ``wk``, ``wv`` and ``wo`` of ``head_dim`` a head,
as the program's ``models/attention.py::init_attn`` defines them.  The
layout of a configuration file that names none."""
from __future__ import annotations

from typing import List

from work.kernels import attended_pairs

from . import Leaf, mlp_leaves, mlp_matmul_params

ARCH_KEYS: tuple = ()
ARCH_FIXED: dict = {}


def layer_leaves(cfg: dict, li: int) -> List[Leaf]:
    """RMSNorm weights, the GQA projections, then the MLP."""
    d, h, kv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["head_dim"])
    return [Leaf("ln1", (d,), None),
            Leaf("mixer.wq", (d, h * hd), d ** -0.5),
            Leaf("mixer.wk", (d, kv * hd), d ** -0.5),
            Leaf("mixer.wv", (d, kv * hd), d ** -0.5),
            Leaf("mixer.wo", (h * hd, d), (h * hd) ** -0.5),
            Leaf("ln2", (d,), None)] + mlp_leaves(cfg, li)


def layer_matmul_params(cfg: dict, li: int) -> int:
    d, h, kv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["head_dim"])
    return d * h * hd * 2 + d * kv * hd * 2 + mlp_matmul_params(cfg, li)


def attention_flops(cfg: dict, b: int, s: int, t: int, q_start: int = 0
                    ) -> float:
    """2 a multiply-add of q.k and of p.v, ``head_dim`` each, a pair."""
    pairs = b * cfg["num_heads"] * attended_pairs(s, t, True, 0, q_start)
    return float(cfg["num_layers"] * 4 * pairs * cfg["head_dim"])


def attn_shape(cfg: dict) -> tuple:
    hd = cfg["head_dim"]
    return cfg["num_heads"], cfg["num_kv_heads"], hd, hd
