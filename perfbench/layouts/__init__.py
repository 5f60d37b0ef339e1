"""Layer layouts: what a decoder layer of a configuration holds, which of
the configuration file's keys reach the program, and what work a layer
does.  A configuration file names its layout under ``"layout"`` (``"gqa"``
where it names none), and the layout is the module of that name here.
Each defines:

  * ``layer_leaves(cfg, li)``: the ``Leaf``s of decoder layer
    ``li``, named as the program names them, laid out (in, out), at the
    program's init scales (None: a norm's weight, drawn as ones);
  * ``ARCH_KEYS``: the configuration file's keys that ``program.arch_of``
    passes to the program's ``ArchConfig`` beside ``program.SIZE_KEYS``;
  * ``ARCH_FIXED``: the ``ArchConfig`` fields the layout sets itself;
  * ``layer_matmul_params(cfg, li)``: the weights a token multiplies by
    in layer ``li`` (the active ones of an MoE layer);
  * ``attention_flops(cfg, b, s, t, q_start)``: the scores and values of
    every layer over b rows of s queries (from position ``q_start``)
    against t keys, causal;
  * ``attn_shape(cfg)``: (heads, KV heads, q.k head size, v head size) of
    the flash kernel's call, for its roofline.

The MLP half of a layer, dense or MoE, is the same in every layout:
``mlp_leaves`` and ``mlp_matmul_params`` below.  A new kind of layer is a
new file here and a new ``reference/<name>.py``; no file that is there
changes.

This package imports nothing of the harness's machinery (``pbcore``), of
the program or of the reference: ``pbcore.weights`` and ``work.flops``
import it.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent


class Leaf(NamedTuple):
    name: str
    shape: tuple
    scale: Optional[float]     # None: ones (a norm's weight)


def is_moe_layer(cfg: dict, li: int) -> bool:
    return cfg.get("num_experts", 0) > 0 and li >= cfg.get(
        "first_dense_layers", 0)


def of(cfg: dict):
    """The layout module that configuration ``cfg`` names."""
    name = cfg.get("layout", "gqa")
    if not (isinstance(name, str) and re.fullmatch(r"[a-z][a-z0-9_]*", name)
            and (HERE / f"{name}.py").is_file()):
        raise ValueError(f"configs/{cfg.get('name')}.json names the layer "
                         f"layout {name!r}, which has no module "
                         f"{HERE.name}/{name}.py")
    return importlib.import_module(f"{__name__}.{name}")


def mlp_leaves(cfg: dict, li: int) -> List[Leaf]:
    """The MLP of layer ``li``: a SwiGLU MLP, or an MoE MLP (f32 router,
    stacked experts, the shared experts as one MLP of width ``moe_d_ff *
    num_shared_experts``)."""
    d = cfg["d_model"]
    if is_moe_layer(cfg, li):
        e, f = cfg["num_experts"], cfg["moe_d_ff"]
        fs = f * cfg["num_shared_experts"]
        out = [Leaf("mlp.router", (d, e), d ** -0.5),
               Leaf("mlp.w_gate", (e, d, f), d ** -0.5),
               Leaf("mlp.w_up", (e, d, f), d ** -0.5),
               Leaf("mlp.w_down", (e, f, d), f ** -0.5)]
        if fs:
            out += [Leaf("mlp.shared.w_gate", (d, fs), d ** -0.5),
                    Leaf("mlp.shared.w_up", (d, fs), d ** -0.5),
                    Leaf("mlp.shared.w_down", (fs, d), fs ** -0.5)]
        return out
    f = cfg["d_ff"]
    return [Leaf("mlp.w_gate", (d, f), d ** -0.5),
            Leaf("mlp.w_up", (d, f), d ** -0.5),
            Leaf("mlp.w_down", (f, d), f ** -0.5)]


def mlp_matmul_params(cfg: dict, li: int) -> int:
    """Weights a token multiplies by in layer ``li``'s MLP: an MoE layer
    its router, its top-k experts and its shared experts."""
    d = cfg["d_model"]
    if is_moe_layer(cfg, li):
        f = cfg["moe_d_ff"]
        return (d * cfg["num_experts"]
                + (cfg["top_k"] + cfg["num_shared_experts"]) * 3 * d * f)
    return 3 * d * cfg["d_ff"]
