"""Mixture-of-Experts MLP, after ``repro.models.moe``: shared + routed
experts, top-k routing, capacity-based dropping.

The function is the reference's ``_moe_mlp_dense`` (``moe.py:77-115``):

  * an f32 softmax router, ``top_k`` with ties to the lower expert index
    (as ``lax.top_k``), the k weights renormalised;
  * each (token, slot) pair's place in its expert's queue, in token-major
    order; a pair whose place is at or past the capacity (``_capacity``)
    is dropped;
  * the kept pairs' expert SwiGLU/GeGLU outputs weighted and summed over
    the k slots, the shared experts added on top.

The reference scatters every pair into an (E, capacity, D) buffer and runs
each expert's matmuls over its whole buffer.  Dropless archs
(``capacity_factor`` 0, deepseek-v2-lite) have capacity = tokens, so that
buffer is (64, T, D) and its matmuls 64x the routed work.  The port
computes the same function on the kept pairs alone: they are sorted by
expert (stably, so each expert's rows stay in queue order) and each
expert's matmuls run on its segment.  The segments' lengths are read back
to the host once a call.

Not ported: the ``shard_map`` path over a mesh (``moe.py:172-210``) and
``aux_load_balance_loss``, which belong to ``distributed/*`` and training
(ROADMAP A8).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import layers as L

Tensor = torch.Tensor


def init_moe(cfg: ArchConfig) -> dict:
    """The ``layers.Init`` tree of one MoE MLP: the f32 router (D, E), the
    stacked experts (E, D, F) / (E, F, D), and the shared experts as one
    dense MLP of width ``moe_d_ff * num_shared_experts``."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s_in, s_f = d ** -0.5, f ** -0.5
    p = {"router": L.Init((d, e), s_in, torch.float32),
         "w_gate": L.Init((e, d, f), s_in),
         "w_up": L.Init((e, d, f), s_in),
         "w_down": L.Init((e, f, d), s_f)}
    if cfg.num_shared_experts:
        p["shared"] = L.init_dense_mlp(d, cfg.moe_d_ff
                                       * cfg.num_shared_experts)
    return p


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    """Queue places an expert has: ``tokens`` when dropless
    (``capacity_factor <= 0``), else tokens * k / E * factor; padded to a
    multiple of 8, at least 8."""
    if cfg.capacity_factor <= 0:
        c = tokens
    else:
        c = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """Where each (token, slot) pair goes, flattened token-major (T * k)."""
    expert: Tensor     # int64 expert index
    weight: Tensor     # f32 renormalised gate weight
    pos: Tensor        # int64 place in the expert's queue
    keep: Tensor       # bool: pos < capacity
    gates: Tensor      # (T, E) f32 softmax of the router


def route(p, x2: Tensor, cfg: ArchConfig) -> Routing:
    """The reference's routing of ``x2`` (T, D)."""
    t, e, k = x2.shape[0], cfg.num_experts, cfg.top_k
    gates = torch.softmax(x2.float() @ p["router"], dim=-1)
    # a stable descending sort puts equal gates in index order: lax.top_k
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    counts = torch.bincount(e_flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(e_flat)
    pos[order] = (torch.arange(t * k, device=x2.device)
                  - starts[e_flat[order]])
    return Routing(e_flat, w.reshape(-1), pos, pos < _capacity(t, cfg),
                   gates)


def moe_mlp(p, x: Tensor, cfg: ArchConfig) -> Tensor:
    """x (..., D) -> (..., D) in x's dtype."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t, k = x2.shape[0], cfg.top_k
    r = route(p, x2, cfg)
    # the kept pairs by expert in queue order, the dropped ones last
    key = torch.where(r.keep, r.expert, cfg.num_experts)
    rows = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=cfg.num_experts + 1).tolist()
    y_tok = torch.zeros((t * k, shape[-1]), dtype=x2.dtype, device=x2.device)
    start = 0
    for ex, n in enumerate(counts[:-1]):
        if not n:
            continue
        seg = rows[start:start + n]
        start += n
        xe = x2[seg // k]
        a = xe @ p["w_gate"][ex]
        a = F.silu(a) if cfg.act == "silu" else F.gelu(a, approximate="tanh")
        y_tok[seg] = (a * (xe @ p["w_up"][ex])) @ p["w_down"][ex]
    y_tok = y_tok * (r.weight * r.keep).to(y_tok.dtype)[:, None]
    y = y_tok.reshape(t, k, -1).sum(1)
    if "shared" in p:
        y = y + L.dense_mlp(p["shared"], x2, cfg.act)
    return y.reshape(shape)
