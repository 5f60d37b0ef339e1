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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
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


def mamba_block(p, x: Tensor, cfg: ArchConfig, chunk: int = 128) -> Tensor:
    """The forward with no cache.  The chunk is ``chunk`` when it divides
    S, S itself when S is shorter, else the largest of 64, 32, ..., 1
    that divides S (the reference's choice; prefill chooses otherwise)."""
    b, s, _ = x.shape
    z, xs, Bm, Cm, dt = _project(p, x, cfg)
    A = -torch.exp(p["A_log"])
    ck = chunk if s % chunk == 0 else (s if s < chunk else next(
        c for c in (64, 32, 16, 8, 4, 2, 1) if s % c == 0))
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
    z, xs, Bm, Cm, dt = _project(p, x, cfg)
    A = -torch.exp(p["A_log"])
    ck = 128 if s % 128 == 0 else next(c for c in (64, 32, 16, 8, 4, 2, 1)
                                       if s % c == 0)
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
