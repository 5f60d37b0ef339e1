"""The plain reference of a configuration whose layers are latent
attention (layout ``mla``): DeepSeek-V2's Multi-head Latent Attention
(arXiv:2405.04434) in PyTorch operations alone, float32, decompressed, no
kernels and no KV cache, written from the configuration file's sizes
(h heads, latent r = ``kv_lora_rank``, nd = ``qk_nope_dim``, rd =
``qk_rope_dim``, vd = ``v_head_dim``).

The attention of a layer over x (B, S, D):

  * q = x Wq, h heads of nd + rd, the last rd of each rotated by RoPE;
  * [c, k_r] = x W_dkv: the latent c (B, S, r), RMS-normed by
    ``kv_norm``, and k_r (B, S, rd), rotated, one key shared by the heads;
  * [k_n, v] = c W_ukv, h heads of nd + vd; a head's key is [k_n, k_r];
  * causal softmax of q.k at scale (nd + rd)^-0.5, the weighted values
    of every head concatenated, then Wo.

RoPE is the repository's half-split rotation at the configuration's
``rope_theta``, over the rd dims.  Where this departs from the published
DeepSeek models (a configuration lists it under ``departures``): their
rotation pairs interleaved dims, and their YaRN (DeepSeek-V2-Lite's and
V3's factor 40) stretches the angles and multiplies the softmax scale by
its mscale squared; neither is computed here, nor by the program.

Everything else is ``transformer.py``'s: the embedding, the norms, the
SwiGLU MLP, the MoE with its capacity and queue, the head and TF32, so
one MoE reference serves both layouts.  ``forward_logits`` and
``served_logits`` are ``transformer.py``'s, with this module's
``attention`` and ``rope_angles`` in its layers.  There is no training
step: ``TrainReference`` stops a training mix on such a configuration.
This module imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import transformer as T

Tensor = torch.Tensor
set_tf32 = T.set_tf32


def rope_angles(positions: Tensor, cfg: dict) -> Tensor:
    """(B, S, rd / 2) angles of (B, S) positions."""
    half = cfg["qk_rope_dim"] // 2
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(half, dtype=torch.float32,
                     device=positions.device) / half))
    return positions.float()[..., None] * inv


def attention(w: Dict[str, Tensor], x: Tensor, ang: Tensor,
              cfg: dict) -> Tensor:
    b, s, _ = x.shape
    nh, r = cfg["num_heads"], cfg["kv_lora_rank"]
    nd, rd, vd = cfg["qk_nope_dim"], cfg["qk_rope_dim"], cfg["v_head_dim"]
    q = (x @ w["mixer.wq"]).view(b, s, nh, nd + rd)
    q = torch.cat([q[..., :nd], T.apply_rope(q[..., nd:], ang)], dim=-1)
    dkv = x @ w["mixer.w_dkv"]
    c = T.rms_norm(dkv[..., :r], w["mixer.kv_norm"], cfg["norm_eps"])
    k_r = T.apply_rope(dkv[..., None, r:], ang)              # (B, S, 1, rd)
    kv = (c @ w["mixer.w_ukv"]).view(b, s, nh, nd + vd)
    k = torch.cat([kv[..., :nd], k_r.expand(b, s, nh, rd)], dim=-1)
    scores = torch.einsum("bshd,bthd->bhst", q, k) * (nd + rd) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, kv[..., nd:])
    return out.reshape(b, s, nh * vd) @ w["mixer.wo"]


def forward_logits(cfg: dict, top: Dict[str, Tensor],
                   layer_weights: Callable[[int], Dict[str, Tensor]],
                   tokens: Tensor, positions: Optional[Tensor] = None
                   ) -> Tensor:
    return T.forward_logits(cfg, top, layer_weights, tokens, positions,
                            attention, rope_angles)


def served_logits(cfg: dict, top: Dict[str, Tensor],
                  layer_weights: Callable[[int], Dict[str, Tensor]],
                  batches: List[Tensor], prompt_len: int) -> List[Tensor]:
    return T.served_logits(cfg, top, layer_weights, batches, prompt_len,
                           attention, rope_angles)


class TrainReference:
    """No training step is written for MLA layers yet."""

    def __init__(self, cfg: dict, opt: dict, params: Dict[str, Tensor]):
        raise NotImplementedError(
            f"{cfg['name']}: reference/mla.py has no training step; a "
            f"training mix needs one written beside its forward")
