"""Mamba-2 SSD (state-space duality) blocks, after ``repro.models.mamba2``:
the chunked matmul form for the forward and prefill, the O(1) recurrent
form for decode.

The minimal SSD algorithm of Dao & Gu (arXiv:2405.21060): within a chunk
the output is an attention-like masked matmul; across chunks a small
recurrent state (H, P, N) is passed.  As in the reference, every product
is a torch einsum in f32 (the reference computes them outside any
kernel); the one sequential pass is a Python loop over the chunks that
carries the (B, H, P, N) state.

``ssd_chunked_seq`` (the reference's scan-over-chunks form) stays as the
tests' oracle: ``ssd_chunked`` == ``ssd_chunked_seq`` == the
``ssd_step`` recurrence.

Tensor parallelism (DTensor parameters, ``distributed.tensor_parallel``):
``w_z``, ``w_x`` and ``conv_x`` are sharded over ``model`` by their
d_inner channels and ``out_proj`` by its rows (``param_specs``), so each
rank runs the block on its SSD heads in ``local_map`` (``_block_tp``,
``_decode_tp``): its channels of z and x, all of B, C (their projections
are replicated) as the groups its heads read, its heads' dt and A; the
gated norm's sum of squares over all d_inner channels is one all-reduce
over ``model`` (``collectives.sum_over_group``) and ``out_proj``'s
partial sums one more (``layers.reduced``).  When the heads do not
divide the axis, every rank runs all heads and keeps its rows' block for
``out_proj``.  The caches follow ``kv_cache_specs``: the SSM state by
heads, each rank's own; the conv history (B, width - 1, d_inner + 2gn)
by its channels, written through DTensor's dispatch and read whole (a
few rows a step).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed import collectives as C
from ..distributed import tensor_parallel as tp
from ..distributed.tensor_parallel import Replicate, Shard
from . import layers as L

Tensor = torch.Tensor


def init_mamba(cfg: ArchConfig) -> dict:
    """The ``layers.Init`` tree of one Mamba2 mixer: the projections kept
    apart (w_z, w_x, w_B, w_C, w_dt), the depthwise conv weights, ``A_log``
    and ``dt_bias`` as f32 zeros (A = -exp(A_log) = -1), the gated norm and
    ``out_proj``."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    s = d ** -0.5
    return {"w_z": L.Init((d, di), s),
            "w_x": L.Init((d, di), s),
            "w_B": L.Init((d, g * n), s),
            "w_C": L.Init((d, g * n), s),
            "w_dt": L.Init((d, h), s),
            "conv_x": L.Init((cfg.conv_width, di), 0.1),
            "conv_B": L.Init((cfg.conv_width, g * n), 0.1),
            "conv_C": L.Init((cfg.conv_width, g * n), 0.1),
            "A_log": L.Init((h,), 0.0, torch.float32),
            "dt_bias": L.Init((h,), 0.0, torch.float32),
            "norm": L.init_rms(di),
            "out_proj": L.Init((di, d), di ** -0.5)}


def _causal_conv(x: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal conv along time: x (b, s, ch), w (width, ch)."""
    s = x.shape[1]
    pad = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return sum(pad[:, i:i + s] * w[i] for i in range(w.shape[0]))


def _segsum(a: Tensor) -> Tensor:
    """a (..., L) -> (..., L, L) with out[i, j] = sum_{k in (j, i]} a[k],
    -inf above the diagonal (the 1-semiseparable decay mask)."""
    n = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                chunk: int = 128, init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """SSD forward, chunk-parallel.  x (b, s, h, p), dt (b, s, h), A (h,)
    negative, B and C (b, s, g, n); returns (y (b, s, h, p), final state
    (b, h, p, n)), both in x's dtype.  Heads are grouped (g, rep) so B and
    C are never repeated up to h heads."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc, rep = s // chunk, h // g
    xc = x.reshape(b, nc, chunk, g, rep, p).float()
    dtc = dt.reshape(b, nc, chunk, g, rep).float()
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()
    Af = A.reshape(g, rep).float()

    dA = dtc * Af                                   # (b, k, l, g, r)
    A_cum = torch.cumsum(dA, dim=2)
    A_tot = A_cum[:, :, -1]                         # (b, k, g, r)
    xdt = xc * dtc[..., None]                       # (b, k, l, g, r, p)

    # intra-chunk: per-group scores, per-head decay mask
    Lmask = torch.exp(_segsum(dA.movedim(2, 4)))    # (b, k, g, r, l, l)
    scores = torch.einsum("bklgn,bksgn->bkgls", Cc, Bc)
    attn = scores[:, :, :, None] * Lmask
    y_diag = torch.einsum("bkgrls,bksgrp->bklgrp", attn, xdt)

    # per-chunk local end states
    decay_to_end = torch.exp(A_tot[:, :, None] - A_cum)
    local = torch.einsum("bklgn,bklgr,bklgrp->bkgrpn", Bc, decay_to_end, xdt)

    # the sequential pass: the state entering each chunk
    T = torch.exp(A_tot)
    state = (torch.zeros((b, g, rep, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.reshape(b, g, rep, p, n).float())
    enter = []
    for kk in range(nc):
        enter.append(state)
        state = state * T[:, kk, ..., None, None] + local[:, kk]
    S_enter = torch.stack(enter, dim=1)             # (b, k, g, r, p, n)

    y_off = torch.einsum("bklgn,bkgrpn,bklgr->bklgrp", Cc, S_enter,
                         torch.exp(A_cum))
    y = (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
    return y, state.reshape(b, h, p, n).to(x.dtype)


def ssd_chunked_seq(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                    chunk: int = 128, init_state: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """The reference's sequential scan over chunks (its pre-hillclimb
    form), kept as an oracle of ``ssd_chunked``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc, rep = s // chunk, h // g
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()
    Af = A.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for kk in range(nc):
        xi, dti = xc[:, kk], dtc[:, kk]
        Bi = torch.repeat_interleave(Bc[:, kk], rep, dim=2)   # (b, l, h, n)
        Ci = torch.repeat_interleave(Cc[:, kk], rep, dim=2)
        dA = (dti * Af).movedim(-1, 1)                        # (b, h, l)
        A_cum = torch.cumsum(dA, dim=-1)
        Lmask = torch.exp(_segsum(dA))                        # (b, h, l, l)
        y_diag = torch.einsum("blhn,bshn,bhls,bsh,bshp->blhp",
                              Ci, Bi, Lmask, dti, xi)
        y_off = torch.einsum("blhn,bhpn,bhl->blhp", Ci, state,
                             torch.exp(A_cum))
        decay_to_end = torch.exp(A_cum[..., -1:] - A_cum)
        state = (state * torch.exp(A_cum[..., -1])[..., None, None]
                 + torch.einsum("blhn,bhl,blh,blhp->bhpn",
                                Bi, decay_to_end, dti, xi))
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p).to(x.dtype)
    return y, state.to(x.dtype)


def ssd_step(state: Tensor, x: Tensor, dt: Tensor, A: Tensor, B: Tensor,
             C: Tensor) -> Tuple[Tensor, Tensor]:
    """One recurrent step: state (b, h, p, n); x (b, h, p); dt (b, h); B, C
    (b, g, n).  Returns (y (b, h, p) in x's dtype, the new state in
    state's dtype)."""
    rep = x.shape[1] // B.shape[1]
    Bh = torch.repeat_interleave(B, rep, dim=1).float()      # (b, h, n)
    Ch = torch.repeat_interleave(C, rep, dim=1).float()
    dA = torch.exp(dt.float() * A.float())                   # (b, h)
    upd = dt.float()[..., None, None] * x.float()[..., None] \
        * Bh[..., None, :]                                   # (b, h, p, n)
    new_state = state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state.to(state.dtype)


# ------------------------------------------------------------- full block

def _project(p, x: Tensor, cfg: ArchConfig):
    """x (b, s, d) -> z, xs (conv + silu), B, C, dt (forward and prefill)."""
    b, s, _ = x.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, hp = cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ p["w_z"]
    xr = _causal_conv(x @ p["w_x"], p["conv_x"])
    Br = _causal_conv(x @ p["w_B"], p["conv_B"])
    Cr = _causal_conv(x @ p["w_C"], p["conv_C"])
    xs = F.silu(xr).reshape(b, s, h, hp)
    Bm = F.silu(Br).reshape(b, s, g, n)
    Cm = F.silu(Cr).reshape(b, s, g, n)
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    return z, xs, Bm, Cm, dt


def _gated_out(p, y: Tensor, z: Tensor) -> Tensor:
    return L.rms_norm(y * F.silu(z), p["norm"]) @ p["out_proj"]


def _block_chunk(s: int, chunk: int = 128) -> int:
    return chunk if s % chunk == 0 else (s if s < chunk else next(
        c for c in (64, 32, 16, 8, 4, 2, 1) if s % c == 0))


def _prefill_chunk(s: int) -> int:
    return 128 if s % 128 == 0 else next(c for c in (64, 32, 16, 8, 4, 2, 1)
                                         if s % c == 0)


def mamba_block(p, x: Tensor, cfg: ArchConfig, chunk: int = 128) -> Tensor:
    """The forward with no cache.  The chunk is ``chunk`` when it divides
    S, S itself when S is shorter, else the largest of 64, 32, ..., 1
    that divides S (the reference's choice; prefill chooses otherwise)."""
    b, s, _ = x.shape
    if tp.is_dtensor(x):
        return _block_tp(p, x, cfg, _block_chunk(s, chunk))
    z, xs, Bm, Cm, dt = _project(p, x, cfg)
    A = -torch.exp(p["A_log"])
    ck = _block_chunk(s, chunk)
    y, _ = ssd_chunked(xs, dt, A, Bm, Cm, chunk=ck)
    return _gated_out(p, y.reshape(b, s, cfg.d_inner), z)


def mamba_prefill(p, x: Tensor, cache: Dict[str, Tensor], cfg: ArchConfig
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The reference's ``transformer._mamba_prefill``: the chunked forward
    from the cache's SSM state (chunk 128 when it divides S, else the
    largest of 64, ..., 1 that does), writing the final state and the
    last ``conv_width - 1`` raw projected inputs [x; B; C] into the cache
    in place.  A prompt shorter than ``conv_width - 1`` leaves the conv
    history as it was, as the reference does."""
    b, s, _ = x.shape
    if tp.is_dtensor(x):
        out = _block_tp(p, x, cfg, _prefill_chunk(s), cache["ssm"])
        _write_conv_tail(p, x, cache, cfg)
        return out, cache
    z, xs, Bm, Cm, dt = _project(p, x, cfg)
    A = -torch.exp(p["A_log"])
    ck = _prefill_chunk(s)
    y, final = ssd_chunked(xs, dt, A, Bm, Cm, chunk=ck,
                           init_state=cache["ssm"])
    out = _gated_out(p, y.reshape(b, s, cfg.d_inner), z)
    w = cfg.conv_width - 1
    if s >= w:
        tail = x[:, s - w:]
        cache["conv"].copy_(torch.cat(
            [tail @ p["w_x"], tail @ p["w_B"], tail @ p["w_C"]], dim=-1))
    cache["ssm"].copy_(final)
    return out, cache


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, Tensor]:
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * g * n),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                               dtype=dtype, device=device)}


def mamba_decode_step(p, x: Tensor, cache: Dict[str, Tensor],
                      cfg: ArchConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x (b, 1, d) -> (y (b, 1, d), cache), the cache updated in place (the
    SSM state cast to the cache's dtype after the step)."""
    b = x.shape[0]
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h, hp = cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0]
    if tp.is_dtensor(x):
        return _decode_tp(p, x0, cache, cfg)[:, None], cache
    z = x0 @ p["w_z"]
    xbc_new = torch.cat([x0 @ p["w_x"], x0 @ p["w_B"], x0 @ p["w_C"]], -1)
    hist = torch.cat([cache["conv"], xbc_new[:, None].to(cache["conv"].dtype)],
                     dim=1)
    w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    xbc = F.silu((hist * w[None]).sum(1))
    xs = xbc[..., :di].reshape(b, h, hp)
    Bm = xbc[..., di:di + g * n].reshape(b, g, n)
    Cm = xbc[..., di + g * n:].reshape(b, g, n)
    dt = F.softplus((x0 @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_ssm = ssd_step(cache["ssm"], xs, dt, A, Bm, Cm)
    out = _gated_out(p, y.reshape(b, di), z)[:, None]
    cache["conv"].copy_(hist[:, 1:])
    cache["ssm"].copy_(new_ssm)
    return out, cache


# ------------------------------------------------- tensor parallelism

_SHARDED = ("w_z", "w_x", "conv_x")
_REPLICATED = ("w_B", "w_C", "w_dt", "conv_B", "conv_C", "A_log",
               "dt_bias", "norm")


class _Plan:
    """A rank's part of a Mamba2 block on ``mesh``: heads [h0, h0 + hl)
    (all of them when they do not divide ``model``), its d_inner
    channels [c0, c0 + cl) for ``out_proj``'s rows, and whether the
    output is a partial sum over ``model``."""

    def __init__(self, p, cfg: ArchConfig, mesh):
        n, r = tp.model_size(mesh), tp.model_rank(mesh)
        self.heads = (n > 1 and tp.on_model(p["w_x"]) == Shard(1)
                      and cfg.ssm_heads % n == 0)
        self.rows = n > 1 and tp.on_model(p["out_proj"]) == Shard(0)
        h = cfg.ssm_heads
        self.hl = h // n if self.heads else h
        self.h0 = r * self.hl if self.heads else 0
        self.cl = cfg.d_inner // n if self.rows else cfg.d_inner
        self.c0 = r * self.cl if self.rows else 0
        self.group = mesh.get_group(tp.MODEL) if self.heads else None

    def in_placements(self, p):
        """Each weight's placement inside ``local_map``: the channel-
        sharded ones as they are on head shards (else gathered), the
        others replicated over ``model``."""
        return {k: (p[k].placements if self.heads or k == "out_proj"
                    else tp.with_model(p[k], Replicate()))
                for k in _SHARDED + _REPLICATED + ("out_proj",)}


def _local_groups(m: Tensor, g: int, h0: int, hl: int, h: int) -> Tensor:
    """The groups (..., g, n) that heads [h0, h0 + hl) read, as groups of
    the local heads (local head i reads local group i // (hl / g'))."""
    rep = h // g
    if hl % rep == 0:
        return m[..., h0 // rep:(h0 + hl) // rep, :]
    if rep % hl == 0:
        j = h0 // rep
        return m[..., j:j + 1, :]
    return m.repeat_interleave(rep, dim=-2)[..., h0:h0 + hl, :]


def _gated_out_local(w, y: Tensor, z: Tensor, plan: _Plan,
                     di: int) -> Tensor:
    """``_gated_out`` of the rank's channels: on head shards the norm's
    sum of squares summed over ``model``; else the whole norm, then the
    rank's rows' block for a row-sharded ``out_proj``."""
    u = y * F.silu(z)
    if plan.heads:
        uf = u.float()
        ss = C.sum_over_group((uf * uf).sum(-1, keepdim=True), plan.group)
        norm = w["norm"][plan.c0:plan.c0 + plan.cl].float()
        u = (uf * torch.rsqrt(ss / di + 1e-6) * norm).to(u.dtype)
    else:
        u = L.rms_norm(u, w["norm"])[..., plan.c0:plan.c0 + plan.cl]
    return u @ w["out_proj"]


def _ssm_inputs(w, xl: Tensor, cfg: ArchConfig, plan: _Plan):
    """z, xs, B, C, dt and A of the rank's heads over a sequence."""
    b, s, _ = xl.shape
    g, n, hp = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    h0, hl, h = plan.h0, plan.hl, cfg.ssm_heads
    z = xl @ w["w_z"]
    xr = _causal_conv(xl @ w["w_x"], w["conv_x"])
    Br = _causal_conv(xl @ w["w_B"], w["conv_B"])
    Cr = _causal_conv(xl @ w["w_C"], w["conv_C"])
    xs = F.silu(xr).reshape(b, s, hl, hp)
    Bm = _local_groups(F.silu(Br).reshape(b, s, g, n), g, h0, hl, h)
    Cm = _local_groups(F.silu(Cr).reshape(b, s, g, n), g, h0, hl, h)
    dt = F.softplus((xl @ w["w_dt"]).float() + w["dt_bias"])[..., h0:h0 + hl]
    A = -torch.exp(w["A_log"][h0:h0 + hl])
    return z, xs, Bm, Cm, dt, A


def _run_tp(p, x: Tensor, plan: _Plan, fn, extra=(), extra_pl=()):
    """``fn(xl, weights, *extra_local)`` per rank; the output (B, ..., D)
    ``Partial`` over ``model`` when the rank computed a part of it."""
    mesh = x.device_mesh
    names = _SHARDED + _REPLICATED + ("out_proj",)
    pl = plan.in_placements(p)
    partial = plan.rows
    x_pl = tp.with_model(x, Replicate())
    out_pl = tp.with_model(x, tp.Partial() if partial else Replicate())
    grads = [tp.grad_placements(x_pl, x, partial)] + [
        tp.grad_placements(pl[k], x, partial) for k in names]

    def local(xl, *rest):
        w = dict(zip(names, rest[:len(names)]))
        return fn(xl, w, *rest[len(names):])

    out = tp.run_local(local, (x,) + tuple(p[k] for k in names) + tuple(extra),
                       (x_pl,) + tuple(pl[k] for k in names)
                       + tuple(extra_pl), out_pl, mesh,
                       grads + list(extra_pl))
    return L.reduced(out)


def _block_tp(p, x: Tensor, cfg: ArchConfig, chunk: int,
              ssm: Optional[Tensor] = None) -> Tensor:
    """``mamba_block`` (``ssm`` None) or ``mamba_prefill``'s SSD (from and
    into the DTensor SSM cache ``ssm``) on the rank's heads."""
    plan = _Plan(p, cfg, x.device_mesh)

    def fn(xl, w, *state):
        b, s, _ = xl.shape
        z, xs, Bm, Cm, dt, A = _ssm_inputs(w, xl, cfg, plan)
        y, final = ssd_chunked(xs, dt, A, Bm, Cm, chunk=chunk,
                               init_state=state[0] if state else None)
        if state:
            state[0].copy_(final)
        return _gated_out_local(w, y.reshape(b, s, plan.hl * cfg.ssm_head_dim),
                                z, plan, cfg.d_inner)

    if ssm is None:
        return _run_tp(p, x, plan, fn)
    return _run_tp(p, x, plan, fn, (ssm,), (ssm.placements,))


def _write_conv_tail(p, x: Tensor, cache: Dict[str, Tensor],
                     cfg: ArchConfig) -> None:
    """The prompt's last ``conv_width - 1`` projected inputs [x; B; C]
    into the DTensor conv cache (through DTensor's dispatch)."""
    s, w = x.shape[1], cfg.conv_width - 1
    if s < w:
        return
    tail = x[:, s - w:]
    new = torch.cat([L.linear(tail, p[k]) for k in ("w_x", "w_B", "w_C")],
                    dim=-1)
    conv = cache["conv"]
    cache["conv"].copy_(new.redistribute(conv.device_mesh, conv.placements))


def _decode_tp(p, x0: Tensor, cache: Dict[str, Tensor],
               cfg: ArchConfig) -> Tensor:
    """``mamba_decode_step`` on the rank's heads: the conv history
    (B, width, d_inner + 2gn) built through DTensor's dispatch and read
    whole, the rank's SSM state stepped in place."""
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    hp, h = cfg.ssm_head_dim, cfg.ssm_heads
    conv = cache["conv"]
    xbc_new = torch.cat([L.linear(x0, p[k]) for k in ("w_x", "w_B", "w_C")],
                        -1)
    hist = torch.cat([conv, xbc_new[:, None].to(conv.dtype)], dim=1)
    hist = hist.redistribute(hist.device_mesh,
                             tp.with_model(hist, Replicate()))
    plan = _Plan(p, cfg, x0.device_mesh)
    ssm = cache["ssm"]

    def fn(xl, w, hl_, st):
        b = xl.shape[0]
        c0 = plan.h0 * hp
        cx = plan.hl * hp
        hist_l = torch.cat([hl_[..., c0:c0 + cx], hl_[..., di:]], -1)
        wc = torch.cat([w["conv_x"], w["conv_B"], w["conv_C"]], -1)
        xbc = F.silu((hist_l * wc[None]).sum(1))
        xs = xbc[..., :cx].reshape(b, plan.hl, hp)
        Bm = _local_groups(xbc[..., cx:cx + g * n].reshape(b, g, n), g,
                           plan.h0, plan.hl, h)
        Cm = _local_groups(xbc[..., cx + g * n:].reshape(b, g, n), g,
                           plan.h0, plan.hl, h)
        dt = F.softplus((xl @ w["w_dt"]).float()
                        + w["dt_bias"])[..., plan.h0:plan.h0 + plan.hl]
        A = -torch.exp(w["A_log"][plan.h0:plan.h0 + plan.hl])
        y, new_ssm = ssd_step(st, xs, dt, A, Bm, Cm)
        st.copy_(new_ssm)
        return _gated_out_local(w, y.reshape(b, cx), xl @ w["w_z"], plan, di)

    out = _run_tp(p, x0, plan, fn, (hist, ssm),
                  (hist.placements, ssm.placements))
    conv.copy_(hist[:, 1:].redistribute(conv.device_mesh, conv.placements))
    return out
