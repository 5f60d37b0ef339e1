"""Attention, after ``repro.models.attention``: GQA, sliding-window
(local) layers, qk-norm, RoPE, and KV-cache decode with ring buffers for
local layers.

Layout conventions (the reference's):
  activations  x        (B, S, D)
  queries      q        (B, S, H, hd)
  keys/values  k, v     (B, T, KV, hd)
  kv cache     {"k","v": (B, C, KV, hd), "pos": (C,) int32 (-1 = empty)}

Prefill and the full forward call the flash kernel
(``kernels.ops.flash_attention``) where the reference calls ``_sdpa`` or
its query-chunked form: it computes the same function without
materialising the scores, so the reference's ``CHUNK_THRESHOLD`` has no
counterpart.  Decode calls the decode kernel
(``kernels.ops.decode_attention``) over the cache with ``valid = (pos >=
0) & (pos <= cur_pos)``, and ``cur_pos - pos < window`` on local layers.
The cache ``pos`` is shared by every row of the batch, as in the
reference.  The port writes the cache in place (the reference returns an
updated copy); ``prefill_into_cache`` and ``decode_attention`` still
return it.

Not ported yet: MLA, cross-attention (``cross_attention``,
``encode_cross_kv``) and the mesh constraint
``_context_parallel_constraint``; ``check_supported`` refuses a config
that needs them, and a config with an attention soft cap, which the decode
kernel does not take (as the TPU kernel does not).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig, LayerSpec
from ..kernels import ops as K
from . import layers as L

Tensor = torch.Tensor


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for attention variants the port does
    not run yet, naming the ROADMAP item that ports them."""
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP A12)")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE is not ported yet (ROADMAP A12)")
    if cfg.logit_softcap:
        raise NotImplementedError(
            f"{cfg.name}: attention logit soft cap {cfg.logit_softcap}: the "
            f"decode kernel has none, as the TPU kernel has none "
            f"(ROADMAP A12)")


# ------------------------------------------------------------------ params

def init_attn(cfg: ArchConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = d ** -0.5
    p = {"wq": L.Init((d, h * hd), s),
         "wk": L.Init((d, kv * hd), s),
         "wv": L.Init((d, kv * hd), s),
         "wo": L.Init((h * hd, d), (h * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = L.init_rms(hd)
        p["k_norm"] = L.init_rms(hd)
    return p


# ------------------------------------------------------------------- core

def _window(cfg: ArchConfig, spec: LayerSpec) -> int:
    return cfg.window if spec.attn_kind == "local" and cfg.window else 0


def _project_qkv(p, x: Tensor, cfg: ArchConfig,
                 angles: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    return L.apply_rope(q, angles), L.apply_rope(k, angles), v


def attention(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec,
              positions: Tensor, *, causal: bool = True) -> Tensor:
    """Full (prefill, no cache) self-attention for one layer;
    ``positions`` (B, S) feed RoPE."""
    angles = L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q, k, v = _project_qkv(p, x, cfg, angles)
    b, s = x.shape[:2]
    out = K.flash_attention(q, k, v, causal=causal, window=_window(cfg, spec))
    return out.reshape(b, s, -1) @ p["wo"]


# --------------------------------------------------------------- KV cache

def cache_size(cfg: ArchConfig, spec: LayerSpec, max_len: int) -> int:
    if spec.attn_kind == "local" and cfg.window:
        return min(max_len, cfg.window)
    return max_len


def init_kv_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                  max_len: int, dtype: torch.dtype,
                  device) -> Dict[str, Tensor]:
    c = cache_size(cfg, spec, max_len)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, c, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, c, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((c,), -1, dtype=torch.int32, device=device),
    }


def decode_attention(p, x: Tensor, cache: Dict[str, Tensor], cur_pos: int,
                     cfg: ArchConfig, spec: LayerSpec
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode: write slot ``cur_pos % C`` of the cache (in
    place), attend over the cache.  x (B, 1, D); ``cur_pos`` the absolute
    position of the new token."""
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    c = cache["pos"].shape[0]
    slot = cur_pos % c
    positions = torch.full((b, 1), cur_pos, dtype=torch.int32,
                           device=x.device)
    angles = L.rope_angles(positions, hd, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(p, x, cfg, angles)

    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = cur_pos

    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= cur_pos)
    window = _window(cfg, spec)
    if window:
        valid = valid & (cur_pos - pos < window)
    out = K.decode_attention(q[:, 0], cache["k"], cache["v"],
                             valid[None].expand(b, c))
    return out.to(x.dtype).reshape(b, 1, h * hd) @ p["wo"], cache


def prefill_into_cache(p, x: Tensor, cache: Dict[str, Tensor],
                       cfg: ArchConfig, spec: LayerSpec
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full forward over the prompt that also fills the KV cache (in
    place; the last ``cache_size`` positions for ring caches)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    angles = L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q, k, v = _project_qkv(p, x, cfg, angles)
    out = K.flash_attention(q, k, v, causal=True, window=_window(cfg, spec))
    y = out.reshape(b, s, -1) @ p["wo"]

    c = cache["pos"].shape[0]
    keep = min(c, s)
    tail_pos = torch.arange(s - keep, s, dtype=torch.int32, device=x.device)
    slots = (tail_pos % c).long()   # ring-consistent: decode overwrites LRU
    cache["k"][:, slots] = k[:, s - keep:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, s - keep:].to(cache["v"].dtype)
    cache["pos"][slots] = tail_pos
    return y, cache
