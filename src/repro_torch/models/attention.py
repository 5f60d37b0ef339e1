"""Attention, after ``repro.models.attention``: GQA, sliding-window
(local) layers, the logit soft cap, qk-norm, RoPE and M-RoPE, MLA,
cross-attention, and KV-cache decode with ring buffers for local layers.

Layout conventions (the reference's):
  activations  x        (B, S, D)
  queries      q        (B, S, H, hd)
  keys/values  k, v     (B, T, KV, hd)
  kv cache     {"k","v": (B, C, KV, hd), "pos": (C,) int32 (-1 = empty)}
  MLA cache    {"c_kv": (B, C, r), "k_rope": (B, C, 1, rd), "pos": (C,)}

Prefill, the full forward, the encoder and cross-attention call the flash
kernel (``kernels.ops.flash_attention``) where the reference calls
``_sdpa`` or its query-chunked form: it computes the same function without
materialising the scores, so the reference's ``CHUNK_THRESHOLD`` has no
counterpart.  Decode calls the decode kernel
(``kernels.ops.decode_attention``) over the cache with ``valid = (pos >=
0) & (pos <= cur_pos)``, and ``cur_pos - pos < window`` on local layers.
Both take ``cfg.logit_softcap``.  The cache ``pos`` is shared by every row
of the batch, as in the reference.  The port writes the cache in place
(the reference returns an updated copy); ``prefill_into_cache`` and
``decode_attention`` still return it.

MLA (DeepSeek-V2): prefill runs the flash kernel on the decompressed
heads (hd = nope + rope, hdv = v_head_dim) and caches the compressed
latent and the shared RoPE key, recomputed for the cached tail.  Decode is
the reference's absorbed form (``attention.py:283-325``): attention in the
latent space, as torch einsums and a softmax in f32, which the reference
also computes outside any kernel; it takes no window and no soft cap, as
the reference's does not.

Reference behaviours kept on purpose: M-RoPE applies only in the full
forward with (3, B, S) positions; ``prefill_into_cache`` and
``decode_attention`` rotate by plain RoPE over the absolute position, so
a served qwen2-vl never sees M-RoPE.  Not ported: the mesh constraint
``_context_parallel_constraint`` (a no-op without a mesh; ROADMAP A8).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig, LayerSpec
from ..kernels import ops as K
from . import layers as L

Tensor = torch.Tensor
NEG = -2.0e38


# ------------------------------------------------------------------ params

def init_attn(cfg: ArchConfig, *, cross: bool = False) -> dict:
    """The ``layers.Init`` tree of one attention mixer: MLA's projections
    for an MLA arch (not for ``cross``), else GQA's."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = d ** -0.5
    if cfg.mla and not cross:
        r, rd, nd, vd = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                         cfg.v_head_dim)
        return {"wq": L.Init((d, h * (nd + rd)), s),
                "w_dkv": L.Init((d, r + rd), s),
                "kv_norm": L.init_rms(r),
                "w_ukv": L.Init((r, h * (nd + vd)), r ** -0.5),
                "wo": L.Init((h * vd, d), (h * vd) ** -0.5)}
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


def _angles(cfg: ArchConfig, positions: Tensor) -> Tensor:
    """RoPE angles of ``positions``: M-RoPE for an arch with sections
    given (3, B, S) positions; stream 0 of (3, B, S) positions on a
    plain-RoPE arch; over ``qk_rope_dim`` for MLA."""
    hd = cfg.qk_rope_dim if cfg.mla else cfg.resolved_head_dim
    if cfg.mrope_sections is not None and positions.dim() == 3:
        return L.mrope_angles(positions, hd, cfg.rope_theta,
                              cfg.mrope_sections)
    if positions.dim() == 3:
        positions = positions[0]
    return L.rope_angles(positions, hd, cfg.rope_theta)


def _project_qkv(p, x: Tensor, cfg: ArchConfig,
                 angles: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    if cfg.mla:
        return _project_mla(p, x, cfg, angles)
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    return L.apply_rope(q, angles), L.apply_rope(k, angles), v


def _mla_latent(p, x: Tensor, cfg: ArchConfig,
                angles: Tensor) -> Tuple[Tensor, Tensor]:
    """MLA's cacheable pair of x (B, S, D): the normed latent c_kv (B, S,
    r) and the rotated RoPE key shared by the heads (B, S, 1, rd)."""
    r = cfg.kv_lora_rank
    dkv = x @ p["w_dkv"]
    c_kv = L.rms_norm(dkv[..., :r], p["kv_norm"])
    return c_kv, L.apply_rope(dkv[..., None, r:], angles)


def _project_mla(p, x: Tensor, cfg: ArchConfig, angles: Tensor):
    """DeepSeek-V2 Multi-head Latent Attention, decompressed: q and k of
    nope + rope dims a head (the RoPE key broadcast over the heads), v of
    ``v_head_dim``."""
    b, s, _ = x.shape
    h, nd, rd, vd = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q = (x @ p["wq"]).reshape(b, s, h, nd + rd)
    q_rope = L.apply_rope(q[..., nd:], angles)
    c_kv, k_rope = _mla_latent(p, x, cfg, angles)
    ukv = (c_kv @ p["w_ukv"]).reshape(b, s, h, nd + vd)
    q_full = torch.cat([q[..., :nd], q_rope], -1)
    k_full = torch.cat([ukv[..., :nd], k_rope.expand(b, s, h, rd)], -1)
    return q_full, k_full, ukv[..., nd:].contiguous()


def attention(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec,
              positions: Tensor, *, causal: bool = True) -> Tensor:
    """Full (prefill, no cache) self-attention for one layer; ``positions``
    (B, S), or (3, B, S) M-RoPE streams, feed RoPE."""
    q, k, v = _project_qkv(p, x, cfg, _angles(cfg, positions))
    b, s = x.shape[:2]
    out = K.flash_attention(q, k, v, causal=causal, window=_window(cfg, spec),
                            softcap=cfg.logit_softcap)
    return out.reshape(b, s, -1) @ p["wo"]


def cross_attention(p, x: Tensor, enc_kv: Tuple[Tensor, Tensor],
                    cfg: ArchConfig) -> Tensor:
    """Decoder cross-attention over ``enc_kv`` = (k, v) from
    ``encode_cross_kv``: no mask, no RoPE."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
    k, v = enc_kv
    out = K.flash_attention(q, k, v, causal=False, softcap=cfg.logit_softcap)
    return out.reshape(b, s, -1) @ p["wo"]


def encode_cross_kv(p, enc_out: Tensor,
                    cfg: ArchConfig) -> Tuple[Tensor, Tensor]:
    b, t, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return ((enc_out @ p["wk"]).reshape(b, t, kv, hd),
            (enc_out @ p["wv"]).reshape(b, t, kv, hd))


# --------------------------------------------------------------- KV cache

def cache_size(cfg: ArchConfig, spec: LayerSpec, max_len: int) -> int:
    if spec.attn_kind == "local" and cfg.window:
        return min(max_len, cfg.window)
    return max_len


def init_kv_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                  max_len: int, dtype: torch.dtype,
                  device) -> Dict[str, Tensor]:
    c = cache_size(cfg, spec, max_len)
    pos = torch.full((c,), -1, dtype=torch.int32, device=device)
    if cfg.mla:
        return {"c_kv": torch.zeros((batch, c, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, c, 1, cfg.qk_rope_dim),
                                      dtype=dtype, device=device),
                "pos": pos}
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, c, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, c, kv, hd), dtype=dtype, device=device),
            "pos": pos}


def _mla_decode(p, x: Tensor, cache: Dict[str, Tensor], cur_pos: int,
                slot: int, cfg: ArchConfig, angles: Tensor) -> Tensor:
    """The reference's absorbed-MLA decode: scores = (q_nope W_UK) c_kv +
    q_rope k_rope, out = (w c_kv) W_UV, all in f32, scale (nd + rd)^-0.5."""
    b = x.shape[0]
    h, r, nd, rd, vd = (cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_dim,
                        cfg.qk_rope_dim, cfg.v_head_dim)
    q = (x @ p["wq"]).reshape(b, 1, h, nd + rd)
    q_rope = L.apply_rope(q[..., nd:], angles)
    c_new, k_rope_new = _mla_latent(p, x, cfg, angles)
    cache["c_kv"][:, slot] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slot] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    cache["pos"][slot] = cur_pos

    w_ukv = p["w_ukv"].reshape(r, h, nd + vd).float()
    ckv = cache["c_kv"].float()                                # (B, C, r)
    q_eff = torch.einsum("bhn,rhn->bhr", q[:, 0, :, :nd].float(),
                         w_ukv[..., :nd])
    s_nope = torch.einsum("bhr,btr->bht", q_eff, ckv)
    s_rope = torch.einsum("bhd,btd->bht", q_rope[:, 0].float(),
                          cache["k_rope"][:, :, 0].float())
    logits = (s_nope + s_rope) * (nd + rd) ** -0.5             # (B, H, C)
    pos = cache["pos"]
    logits = torch.where(((pos >= 0) & (pos <= cur_pos))[None, None],
                         logits, NEG)
    w = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", w, ckv)
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_ukv[..., nd:])
    return out.reshape(b, 1, h * vd).to(x.dtype) @ p["wo"]


def decode_attention(p, x: Tensor, cache: Dict[str, Tensor], cur_pos: int,
                     cfg: ArchConfig, spec: LayerSpec
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode: write slot ``cur_pos % C`` of the cache (in
    place), attend over the cache.  x (B, 1, D); ``cur_pos`` the absolute
    position of the new token, rotated by plain RoPE."""
    b = x.shape[0]
    c = cache["pos"].shape[0]
    slot = cur_pos % c
    angles = _angles(cfg, torch.full((b, 1), cur_pos, dtype=torch.int32,
                                     device=x.device))
    if cfg.mla:
        return _mla_decode(p, x, cache, cur_pos, slot, cfg, angles), cache
    h, hd = cfg.num_heads, cfg.resolved_head_dim
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
                             valid[None].expand(b, c),
                             softcap=cfg.logit_softcap)
    return out.to(x.dtype).reshape(b, 1, h * hd) @ p["wo"], cache


def prefill_into_cache(p, x: Tensor, cache: Dict[str, Tensor],
                       cfg: ArchConfig, spec: LayerSpec
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full forward over the prompt that also fills the KV cache (in
    place; the last ``cache_size`` positions for ring caches), RoPE over
    ``arange(S)``."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, _angles(cfg, positions))
    out = K.flash_attention(q, k, v, causal=True, window=_window(cfg, spec),
                            softcap=cfg.logit_softcap)
    y = out.reshape(b, s, -1) @ p["wo"]

    c = cache["pos"].shape[0]
    keep = min(c, s)
    tail_pos = torch.arange(s - keep, s, dtype=torch.int32, device=x.device)
    slots = (tail_pos % c).long()   # ring-consistent: decode overwrites LRU
    if cfg.mla:
        # the cached tail's latents, recomputed (cheap projections)
        c_kv, k_rope = _mla_latent(p, x[:, s - keep:], cfg,
                                   _angles(cfg, tail_pos.expand(b, keep)))
        cache["c_kv"][:, slots] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, slots] = k_rope.to(cache["k_rope"].dtype)
    else:
        cache["k"][:, slots] = k[:, s - keep:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, s - keep:].to(cache["v"].dtype)
    cache["pos"][slots] = tail_pos
    return y, cache
