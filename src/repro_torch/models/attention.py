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
0) & (pos <= cur_pos)``, and ``cur_pos - pos < window`` on local layers
(on ``meta``, where the cache holds no positions, the op counter is told
the count of a cache filled up to ``cur_pos``: ``filled_count``).
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
a served qwen2-vl never sees M-RoPE.

Tensor parallelism (``distributed.tensor_parallel``: parameters, inputs
and caches as DTensors): the projections run through DTensor's dispatch
(``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel, its partial
sums reduced by ``layers.reduced``), and the kernels, which DTensor has
no rule for, run per rank in ``local_map`` (``_flash``, ``_decode_tp``):

  * head shards: each rank runs the flash or decode kernel on its query
    heads (``num_heads`` divides the ``model`` axis) and the KV heads
    they read (sharded when ``num_kv_heads`` divides the axis, else
    replicated and sliced);
  * context parallelism, the reference's ``_context_parallel_constraint``
    (``repro/models/attention.py:172-204``) with its condition (the query
    heads do not divide the axis, the sequence does): q sharded by
    sequence over ``model``, K/V replicated, and each rank's flash call
    takes ``q_start`` = its block's first position, forward and backward;
    the rank's rows then stay sharded through ``wo``, the residual, the
    norms and the MLP (``layers.linear``, ``layers.residual``), gathered
    only for a consumer of every row (the next layer's K/V, the logits
    head, a Mamba2 scan, the MoE layer), as GSPMD keeps them;
  * a sequence-sharded cache (``kv_cache_specs``: the KV heads do not
    divide the axis, and always for MLA's latent): the rank that holds
    slot ``cur_pos % C`` writes it, each rank runs
    ``decode_attention_with_lse`` over its block of the cache, and one
    all-gather of (output, log-sum-exp) over each sharded mesh axis
    merges the blocks (``combine_decode``), B x H x (hd + 1) floats; MLA's
    absorbed decode merges its latent outputs the same way.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig, LayerSpec
from ..distributed import collectives as C
from ..distributed import tensor_parallel as tp
from ..distributed.tensor_parallel import Partial, Replicate, Shard
from ..kernels import ops as K
from ..kernels.attention import LOG2E
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


def _split_heads(y: Tensor, b: int, s: int, heads: int, hd: int) -> Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd); a DTensor whose column
    shards over ``model`` split a head (the heads do not divide the axis)
    is gathered first, the all-gather GSPMD makes there too."""
    if (tp.is_dtensor(y) and tp.on_model(y) == Shard(2)
            and heads % tp.model_size(y.device_mesh)):
        y = y.redistribute(y.device_mesh, tp.with_model(y, Replicate()))
    return y.reshape(b, s, heads, hd)


def _project_qkv(p, x: Tensor, cfg: ArchConfig,
                 angles: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    if cfg.mla:
        return _project_mla(p, x, cfg, angles)
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _split_heads(L.linear(x, p["wq"]), b, s, h, hd)
    k = _split_heads(L.linear(x, p["wk"]), b, s, kv, hd)
    v = _split_heads(L.linear(x, p["wv"]), b, s, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    return L.apply_rope(q, angles), L.apply_rope(k, angles), v


def _mla_latent(p, x: Tensor, cfg: ArchConfig,
                angles: Tensor) -> Tuple[Tensor, Tensor]:
    """MLA's cacheable pair of x (B, S, D): the normed latent c_kv (B, S,
    r) and the rotated RoPE key shared by the heads (B, S, 1, rd)."""
    r = cfg.kv_lora_rank
    dkv = L.linear(x, p["w_dkv"])
    c_kv = L.rms_norm(dkv[..., :r], p["kv_norm"])
    return c_kv, L.apply_rope(dkv[..., None, r:], angles)


def _project_mla(p, x: Tensor, cfg: ArchConfig, angles: Tensor):
    """DeepSeek-V2 Multi-head Latent Attention, decompressed: q and k of
    nope + rope dims a head (the RoPE key broadcast over the heads), v of
    ``v_head_dim``."""
    b, s, _ = x.shape
    h, nd, rd, vd = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q = _split_heads(L.linear(x, p["wq"]), b, s, h, nd + rd)
    q_rope = L.apply_rope(q[..., nd:], angles)
    c_kv, k_rope = _mla_latent(p, x, cfg, angles)
    ukv = _split_heads(L.linear(c_kv, p["w_ukv"]), b, s, h, nd + vd)
    q_full = torch.cat([q[..., :nd], q_rope], -1)
    k_full = torch.cat([ukv[..., :nd], k_rope.expand(b, s, h, rd)], -1)
    return q_full, k_full, ukv[..., nd:].contiguous()


def attention(p, x: Tensor, cfg: ArchConfig, spec: LayerSpec,
              positions: Tensor, *, causal: bool = True) -> Tensor:
    """Full (prefill, no cache) self-attention for one layer; ``positions``
    (B, S), or (3, B, S) M-RoPE streams, feed RoPE."""
    q, k, v = _project_qkv(p, x, cfg, _angles(cfg, positions))
    q, k, v = _context_parallel_constraint(q, k, v, cfg)
    b, s = x.shape[:2]
    out = _flash(q, k, v, causal=causal, window=_window(cfg, spec),
                 softcap=cfg.logit_softcap)
    return L.reduced(L.linear(out.reshape(b, s, -1), p["wo"]))


def cross_attention(p, x: Tensor, enc_kv: Tuple[Tensor, Tensor],
                    cfg: ArchConfig) -> Tensor:
    """Decoder cross-attention over ``enc_kv`` = (k, v) from
    ``encode_cross_kv``: no mask, no RoPE."""
    b, s, _ = x.shape
    q = _split_heads(L.linear(x, p["wq"]), b, s, cfg.num_heads,
                     cfg.resolved_head_dim)
    k, v = enc_kv
    out = _flash(q, k, v, causal=False, softcap=cfg.logit_softcap)
    return L.reduced(L.linear(out.reshape(b, s, -1), p["wo"]))


def encode_cross_kv(p, enc_out: Tensor,
                    cfg: ArchConfig) -> Tuple[Tensor, Tensor]:
    b, t, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return (_split_heads(L.linear(enc_out, p["wk"]), b, t, kv, hd),
            _split_heads(L.linear(enc_out, p["wv"]), b, t, kv, hd))


# ------------------------------------------------- tensor parallelism

def _context_parallel_constraint(q, k, v, cfg: ArchConfig):
    """The reference's context-parallel layout for uneven tensor
    parallelism: when the query heads do not divide the ``model`` axis
    (qwen2-vl's 28 on 16) and the sequence does, q is sharded by sequence
    over ``model`` and K/V replicated over it (one K/V all-gather a layer,
    the attention FLOPs split evenly).  A no-op off a mesh, and where the
    heads divide the axis."""
    if not tp.is_dtensor(q):
        return q, k, v
    n = tp.model_size(q.device_mesh)
    if n == 1 or cfg.num_heads % n == 0 or q.shape[1] % n != 0:
        return q, k, v
    mesh = q.device_mesh
    return (q.redistribute(mesh, tp.with_model(q, Shard(1))),
            k.redistribute(mesh, tp.with_model(k, Replicate())),
            v.redistribute(mesh, tp.with_model(v, Replicate())))


def _kv_heads_of_rank(k: torch.Tensor, h: int, n: int, r: int
                      ) -> torch.Tensor:
    """The KV heads that query heads [r h / n, (r + 1) h / n) read, of a
    replicated (B, T, KV, hd) ``k``, so that local query head i reads
    local KV head i // G' (G' the local group)."""
    kvh = k.shape[2]
    g, hl = h // kvh, h // n
    first = r * hl
    if hl % g == 0:
        return k[:, :, first // g:first // g + hl // g]
    if g % hl == 0:
        j = first // g
        return k[:, :, j:j + 1]
    return k.repeat_interleave(g, dim=2)[:, :, first:first + hl]


def _flash(q, k, v, **kw):
    """``K.flash_attention``, or on DTensors the kernel per rank: on its
    block of the sequence with ``q_start`` when q is sequence-sharded
    over ``model`` (``_context_parallel_constraint``; the output keeps
    the rank's rows), on its query heads when they divide the
    axis, else the whole call on every rank."""
    if not tp.is_dtensor(q):
        return K.flash_attention(q, k, v, **kw)
    mesh = q.device_mesh
    n, r = tp.model_size(mesh), tp.model_rank(mesh)
    b, s, h, _ = q.shape
    c = lambda x: x.contiguous()
    rep_kv = tp.with_model(k, Replicate())
    if n > 1 and tp.on_model(q) == Shard(1):            # context parallel
        q_start = r * (s // n)
        fn = lambda ql, kl, vl: K.flash_attention(
            c(ql), c(kl), c(vl), q_start=q_start, **kw)
        q_pl, kv_pl = tp.with_model(q, Shard(1)), rep_kv
        kv_grad = tp.with_model(k, Partial())
    elif n > 1 and h % n == 0:                          # head shards
        q_pl = tp.with_model(q, Shard(2))
        if k.shape[2] % n == 0:
            kv_pl = kv_grad = tp.with_model(k, Shard(2))
            fn = lambda ql, kl, vl: K.flash_attention(c(ql), c(kl), c(vl),
                                                      **kw)
        else:
            kv_pl, kv_grad = rep_kv, tp.with_model(k, Partial())
            fn = lambda ql, kl, vl: K.flash_attention(
                c(ql), c(_kv_heads_of_rank(kl, h, n, r)),
                c(_kv_heads_of_rank(vl, h, n, r)), **kw)
    else:                                               # whole, replicated
        q_pl, kv_pl = tp.with_model(q, Replicate()), rep_kv
        kv_grad = kv_pl
        fn = lambda ql, kl, vl: K.flash_attention(c(ql), c(kl), c(vl), **kw)
    # context parallel: the rows stay sharded through ``wo``, the
    # residual, the norm and the MLP (``layers.linear``, ``residual``)
    return tp.run_local(fn, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl, mesh,
                        (q_pl, kv_grad, kv_grad))


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


def _mla_decode_tp(p, x: Tensor, cache: Dict[str, Tensor], cur_pos: int,
                   slot: int, cfg: ArchConfig, angles: Tensor) -> Tensor:
    """``_mla_decode`` on DTensors: the latent caches sequence-sharded
    (``kv_cache_specs``), ``w_ukv`` sharded by heads.  Each rank absorbs
    its heads' W_UK into q, one all-gather over ``model`` gives every
    rank all heads' absorbed queries, each rank attends in the latent
    space over its block of the cache (its slot written by the rank that
    holds it), the blocks merge by log-sum-exp (``_merge_over``), and
    each rank maps its heads' latent outputs through W_UV."""
    b = x.shape[0]
    h, r, nd, rd, vd = (cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_dim,
                        cfg.qk_rope_dim, cfg.v_head_dim)
    q = _split_heads(L.linear(x, p["wq"]), b, 1, h, nd + rd)
    q_rope = L.apply_rope(q[..., nd:], angles)
    c_new, k_rope_new = _mla_latent(p, x, cfg, angles)
    ckv, krp, pos = cache["c_kv"], cache["k_rope"], cache["pos"]
    mesh = ckv.device_mesh
    seq = tp.cache_seq_dims(ckv)
    lo, length = tp.seq_block(ckv) if seq else (0, ckv.shape[1])
    w_ukv = p["w_ukv"]
    heads = tp.on_model(w_ukv) == Shard(1)
    n, mr = tp.model_size(mesh), tp.model_rank(mesh)
    model_group = mesh.get_group("model") if heads else None

    def step(ql, qrl, cnl, krnl, wl, ckl, krl, pl):
        hl = ql.shape[2]
        pl[slot] = cur_pos
        if lo <= slot < lo + length:
            ckl[:, slot - lo] = cnl[:, 0].to(ckl.dtype)
            krl[:, slot - lo] = krnl[:, 0].to(krl.dtype)
        wf = wl.reshape(r, hl, nd + vd).float()
        q_eff = torch.einsum("bhn,rhn->bhr", ql[:, 0, :, :nd].float(),
                             wf[..., :nd])
        q_r = qrl[:, 0].float()
        if heads:                       # every head's absorbed query
            q_eff = C.gather(q_eff, 1, model_group)
            q_r = C.gather(q_r, 1, model_group)
        c = ckl.float()
        logits = (torch.einsum("bhr,btr->bht", q_eff, c)
                  + torch.einsum("bhd,btd->bht", q_r, krl[:, :, 0].float())
                  ) * (nd + rd) ** -0.5
        pb = pl[lo:lo + length]
        logits = torch.where(((pb >= 0) & (pb <= cur_pos))[None, None],
                             logits, NEG)
        lse = torch.logsumexp(logits, dim=-1) * LOG2E
        o_lat = torch.einsum("bht,btr->bhr", torch.softmax(logits, -1), c)
        o_lat = _merge_over(o_lat, lse, mesh, seq)[0]
        if heads:
            o_lat = o_lat[:, mr * hl:(mr + 1) * hl]
        return torch.einsum("bhr,rhv->bhv", o_lat, wf[..., nd:])

    act = tp.with_model(q, Shard(2) if heads else Replicate())
    rep_c = tp.with_model(c_new, Replicate())
    out = tp.run_local(
        step, (q, q_rope, c_new, k_rope_new, w_ukv, ckv, krp, pos),
        (act, act, rep_c, tp.with_model(k_rope_new, Replicate()),
         w_ukv.placements, ckv.placements, krp.placements, pos.placements),
        tp.with_model(q, Shard(1) if heads else Replicate()), mesh)
    return L.reduced(L.linear(out.reshape(b, 1, h * vd).to(x.dtype),
                              p["wo"]))


def _local_device(x: Tensor) -> torch.device:
    return x.to_local().device if tp.is_dtensor(x) else x.device


def _write_tail(cache: Dict[str, Tensor], new: Dict[str, Tensor],
                first: int, stop: int) -> None:
    """Write the prompt's tail ``new[name]`` (B, keep, ...), positions
    [first, stop), into the DTensor cache entries at slots ``position %
    C``, each rank its own block: its heads, or of a sequence-sharded
    cache the slots in its block; and ``pos`` (replicated) on every
    rank.  The slots are host integers: no device read."""
    pos = cache["pos"]
    dev = pos.to_local().device
    c = pos.shape[0]
    slots = [t % c for t in range(first, stop)]
    for name, val in new.items():
        buf = cache[name]
        seq = tp.cache_seq_dims(buf)
        lo, length = tp.seq_block(buf) if seq else (0, buf.shape[1])
        mine = [i for i, t in enumerate(slots) if lo <= t < lo + length]
        sel = torch.tensor(mine, dtype=torch.long, device=dev)
        idx = torch.tensor([slots[i] - lo for i in mine], dtype=torch.long,
                           device=dev)
        head_sharded = (buf.dim() == 4 and not seq
                        and tp.on_model(buf) == Shard(2))
        val_pl = tp.with_model(val, Shard(2) if head_sharded
                               else Replicate())

        def write(bl, vl, idx=idx, sel=sel):
            bl[:, idx] = vl[:, sel].to(bl.dtype)
            return bl
        tp.run_local(write, (buf, val), (buf.placements, val_pl),
                     buf.placements, buf.device_mesh)
    slot_t = torch.tensor(slots, dtype=torch.long, device=dev)
    tail = torch.arange(first, stop, dtype=torch.int32, device=dev)
    tp.run_local(lambda pl: pl.index_copy_(0, slot_t, tail), (pos,),
                 (pos.placements,), pos.placements, pos.device_mesh)


def _merge_over(out: Tensor, lse: Tensor, mesh, dims) -> Tuple[Tensor,
                                                                Tensor]:
    """(out, lse) of the decode over the union of the ranks' key blocks
    along mesh ``dims``: one all-gather of each over each dim, merged by
    ``combine_decode``; the merged base-2 log-sum-exp beside it."""
    for d in dims:
        group = mesh.get_group(d)
        n = mesh.size(d)
        outs = C.gather(out[None], 0, group).reshape((n,) + out.shape)
        lses = C.gather(lse[None], 0, group).reshape((n,) + lse.shape)
        out = K.combine_decode(outs, lses)
        lse = torch.logsumexp(lses * (1.0 / LOG2E), dim=0) * LOG2E
    return out, lse


def _decode_tp(q, k_new, v_new, cache: Dict[str, Tensor], cur_pos: int,
               slot: int, window: int, softcap: float) -> Tensor:
    """One decode step's attention on a DTensor cache, per rank: write
    the new K/V into slot ``slot`` (the rank's heads, or the rank that
    holds the slot of a sequence-sharded cache), attend with the decode
    kernel over the rank's heads or its block of the sequence, and merge
    the blocks (``_merge_over``).  Returns (B, H, hd) f32."""
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    mesh = ck.device_mesh
    seq = tp.cache_seq_dims(ck)
    heads = not seq and tp.on_model(ck) == Shard(2)
    lo, length = tp.seq_block(ck) if seq else (0, ck.shape[1])
    b = q.shape[0]
    meta = ck.device.type == "meta" or ck.to_local().device.type == "meta"
    n_valid = None
    if meta:    # a cache filled to cur_pos: the valid keys of this block
        n = filled_count(cur_pos, ck.shape[1], window)
        n_valid = min(length, max(0, n - lo))

    def step(ql, kl, vl, ckl, cvl, pl):
        bl = ql.shape[0]
        pl[slot] = cur_pos
        if lo <= slot < lo + length:
            ckl[:, slot - lo] = kl[:, 0].to(ckl.dtype)
            cvl[:, slot - lo] = vl[:, 0].to(cvl.dtype)
        p = pl[lo:lo + length]
        valid = (p >= 0) & (p <= cur_pos)
        if window:
            valid = valid & (cur_pos - p < window)
        kw = {} if n_valid is None else {"valid_count": bl * n_valid}
        valid = valid[None].expand(bl, length)
        if not seq:
            return K.decode_attention(ql[:, 0].contiguous(), ckl, cvl, valid,
                                      softcap=softcap, **kw)
        out, lse = K.decode_attention_with_lse(
            ql[:, 0].contiguous(), ckl, cvl, valid, softcap=softcap, **kw)
        return _merge_over(out, lse, mesh, seq)[0]

    act = tp.with_model(q, Shard(2) if heads else Replicate())
    out_pl = tp.with_model(q, Shard(1) if heads else Replicate())
    return tp.run_local(step, (q, k_new, v_new, ck, cv, pos),
                        (act, act, act, ck.placements, cv.placements,
                         pos.placements), out_pl, mesh)


def filled_count(cur_pos: int, c: int, window: int) -> int:
    """Valid keys of a cache of ``c`` slots that holds every position up
    to ``cur_pos`` (as a prefill and the decode steps after it leave
    it): what ``decode_attention``'s mask lets through, for ``meta``
    tensors, which hold no positions to read it from."""
    n = min(cur_pos + 1, c)
    return min(n, window) if window else n


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
        if tp.is_dtensor(x):
            return _mla_decode_tp(p, x, cache, cur_pos, slot, cfg,
                                  angles), cache
        return _mla_decode(p, x, cache, cur_pos, slot, cfg, angles), cache
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k_new, v_new = _project_qkv(p, x, cfg, angles)
    if tp.is_dtensor(x):
        out = _decode_tp(q, k_new, v_new, cache, cur_pos, slot,
                         _window(cfg, spec), cfg.logit_softcap)
        return L.reduced(L.linear(out.to(x.dtype).reshape(b, 1, h * hd),
                                  p["wo"])), cache
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = cur_pos

    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= cur_pos)
    window = _window(cfg, spec)
    if window:
        valid = valid & (cur_pos - pos < window)
    kw = {}
    if x.device.type == "meta":     # no positions: a cache filled to cur_pos
        kw["valid_count"] = b * filled_count(cur_pos, c, window)
    out = K.decode_attention(q[:, 0], cache["k"], cache["v"],
                             valid[None].expand(b, c),
                             softcap=cfg.logit_softcap, **kw)
    return out.to(x.dtype).reshape(b, 1, h * hd) @ p["wo"], cache


def prefill_into_cache(p, x: Tensor, cache: Dict[str, Tensor],
                       cfg: ArchConfig, spec: LayerSpec
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full forward over the prompt that also fills the KV cache (in
    place; the last ``cache_size`` positions for ring caches), RoPE over
    ``arange(S)``."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=_local_device(x)).expand(b, s)
    if tp.is_dtensor(x):
        positions = tp.batch_input(positions, x.device_mesh)
    q, k, v = _project_qkv(p, x, cfg, _angles(cfg, positions))
    qc, kc, vc = _context_parallel_constraint(q, k, v, cfg)
    out = _flash(qc, kc, vc, causal=True, window=_window(cfg, spec),
                 softcap=cfg.logit_softcap)
    y = L.reduced(L.linear(out.reshape(b, s, -1), p["wo"]))

    c = cache["pos"].shape[0]
    keep = min(c, s)
    tail_pos = torch.arange(s - keep, s, dtype=torch.int32,
                            device=_local_device(x))
    slots = (tail_pos % c).long()   # ring-consistent: decode overwrites LRU
    if tp.is_dtensor(x):
        if L.seq_sharded(k):            # the rank's rows: take the gathered
            k, v = kc, vc
        if cfg.mla:
            tail = tp.batch_input(tail_pos.expand(b, keep), x.device_mesh)
            c_kv, k_rope = _mla_latent(p, L.gather_rows(x)[:, s - keep:],
                                       cfg, _angles(cfg, tail))
            _write_tail(cache, {"c_kv": c_kv, "k_rope": k_rope}, s - keep,
                        s)
        else:
            _write_tail(cache, {"k": k[:, s - keep:], "v": v[:, s - keep:]},
                        s - keep, s)
        return y, cache
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
