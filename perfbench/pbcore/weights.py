"""Seeded weights, made by the benchmark and handed alike to the program
and to the plain reference.

Every leaf is named as the program names it (``"mixer.wq"``,
``"mlp.shared.w_up"``) and laid out (in, out), so neither side
transposes anything.  The weights of one layer are drawn on the device in
ONE call, from a ``torch.Generator`` seeded by (run seed, layer), into a
flat buffer whose slices are the layer's leaves; the embedding, the
unembedding and the final norm are a second such draw.  So any layer can
be drawn again on its own: the reference draws each layer as it reaches
it, after the program's state is freed, and never reads the program's
copy.

This module imports neither the program nor the reference.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Optional

import torch


class Leaf(NamedTuple):
    name: str
    shape: tuple
    scale: Optional[float]     # None: ones (a norm's weight)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for stream ``tag`` of run ``seed`` (any integer)."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def is_moe_layer(cfg: dict, li: int) -> bool:
    return cfg.get("num_experts", 0) > 0 and li >= cfg.get(
        "first_dense_layers", 0)


def layer_leaves(cfg: dict, li: int) -> List[Leaf]:
    """The leaves of decoder layer ``li``: RMSNorm weights, GQA
    projections, then a SwiGLU MLP or an MoE MLP (f32 router, stacked
    experts, the shared experts as one MLP of width ``moe_d_ff *
    num_shared_experts``)."""
    d, h, kv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["head_dim"])
    out = [Leaf("ln1", (d,), None),
           Leaf("mixer.wq", (d, h * hd), d ** -0.5),
           Leaf("mixer.wk", (d, kv * hd), d ** -0.5),
           Leaf("mixer.wv", (d, kv * hd), d ** -0.5),
           Leaf("mixer.wo", (h * hd, d), (h * hd) ** -0.5),
           Leaf("ln2", (d,), None)]
    if is_moe_layer(cfg, li):
        e, f = cfg["num_experts"], cfg["moe_d_ff"]
        fs = f * cfg["num_shared_experts"]
        out += [Leaf("mlp.router", (d, e), d ** -0.5),
                Leaf("mlp.w_gate", (e, d, f), d ** -0.5),
                Leaf("mlp.w_up", (e, d, f), d ** -0.5),
                Leaf("mlp.w_down", (e, f, d), f ** -0.5)]
        if fs:
            out += [Leaf("mlp.shared.w_gate", (d, fs), d ** -0.5),
                    Leaf("mlp.shared.w_up", (d, fs), d ** -0.5),
                    Leaf("mlp.shared.w_down", (fs, d), fs ** -0.5)]
    else:
        f = cfg["d_ff"]
        out += [Leaf("mlp.w_gate", (d, f), d ** -0.5),
                Leaf("mlp.w_up", (d, f), d ** -0.5),
                Leaf("mlp.w_down", (f, d), f ** -0.5)]
    return out


def top_leaves(cfg: dict) -> List[Leaf]:
    """The embedding (V, D), the unembedding (D, V) and the final norm."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    out = [Leaf("embed", (v, d), 0.02)]
    if not cfg.get("tie_embeddings", False):
        out.append(Leaf("unembed", (d, v), d ** -0.5))
    out.append(Leaf("final_norm", (d,), None))
    return out


def _draw(leaves: List[Leaf], seed: int, tag: str, device,
          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    n = sum(math.prod(lf.shape) for lf in leaves if lf.scale is not None)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    flat = torch.empty(n, dtype=dtype, device=device).normal_(generator=gen)
    out, at = {}, 0
    for lf in leaves:
        if lf.scale is None:
            out[lf.name] = torch.ones(lf.shape, dtype=dtype, device=device)
            continue
        k = math.prod(lf.shape)
        out[lf.name] = flat[at:at + k].view(lf.shape).mul_(lf.scale)
        at += k
    return out


def draw_layer(cfg: dict, seed: int, li: int, device,
               dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s leaves, drawn on ``device`` (views of one buffer)."""
    return _draw(layer_leaves(cfg, li), seed, f"layer{li}", device, dtype)


def draw_top(cfg: dict, seed: int, device,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    return _draw(top_leaves(cfg), seed, "top", device, dtype)
