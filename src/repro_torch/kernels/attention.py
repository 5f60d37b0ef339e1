"""The two attention kernels: hand-written CUDA kernels of
``csrc/attention.cu`` and their plain PyTorch versions.

  * ``flash_attention`` replaces ``_flash_kernel`` of
    ``src/repro/kernels/flash_attn.py`` (:47, called at :128): forward
    attention of q (B, S, H, hd) against k (B, T, KV, hd) and v (B, T, KV,
    hdv) with an online softmax in f32: grouped-query heads (head h reads
    KV head h // G, H = KV * G), causal ``kpos <= qpos``, a sliding window
    ``qpos - kpos < window``, a tanh soft cap ``softcap * tanh(x /
    softcap)`` after the scale (``hd ** -0.5`` by default), and hdv != hd.
    The output is (B, S, H, hdv) in q's dtype.  ``flash_kernel`` gives a
    block to (b, KV head, 64 / G query positions), so each K/V tile is
    read once for the G heads that share it, walks the K/V tiles in a loop
    (the Pallas grid's sequential axis) and skips the tiles the masks
    remove.
  * ``decode_attention`` replaces ``_decode_kernel`` of
    ``src/repro/kernels/decode_attn.py`` (:26, called at :87): one query
    token per sequence, q (B, H, hd) against k/v (B, T, KV, hd) under a
    (B, T) validity mask, scale ``hd ** -0.5``, no soft cap, output (B, H,
    hd) f32.  Flash-decoding: ``decode_partial_kernel`` gives a block to
    (b, KV head, ``DECODE_CHUNK`` keys) and ``decode_combine_kernel``
    merges the chunks and divides by ``max(l, 1e-30)``.

Masked logits are -2e38, as in the reference, so a row with no valid key
gets the mean of v over all T keys, as the reference's softmax gives.
The reference pads T to its tile (flash) or asserts ``T % t_block == 0``
(decode): that is its tiling, not the function's, and the kernels take
any S and T.  (The Pallas flash kernel's padded keys take part in a row
that has no valid key; its oracle ``ref.flash_attention`` and the port
average over the T real keys.)

Dtypes: q, k, v float32 or bfloat16, all one type; f32 accumulation.
On CUDA tensors each wrapper launches its kernel (and adds one to its
entry of ``launches``) or raises; on CPU tensors it runs its plain
version (and adds one to ``plain_runs``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from . import _build
from ._build import supported  # noqa: F401

NEG = -2.0e38
DECODE_CHUNK = 128          # keys a decode block (pass 1) reads
MAX_HEAD_DIM = 256
MAX_GROUP = 64              # query heads per KV head a flash block holds
WRAPPERS = ("decode_attention", "flash_attention")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each wrapper's kernel since the last ``reset_launches``,
# and runs of each plain version (which never count as launches).
launches: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)
plain_runs: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)


def reset_launches() -> None:
    for k in WRAPPERS:
        launches[k] = plain_runs[k] = 0


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_dims: int) -> None:
    if q.dim() != q_dims or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must have {q_dims} dims and k, v 4, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    h, hd = q.shape[-2], q.shape[-1]
    b, t, kvh = k.shape[:3]
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if not 1 <= hd <= MAX_HEAD_DIM or not 1 <= v.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"head dims {hd}, {v.shape[3]} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if t < 1:
        raise ValueError("k and v need at least one key (T >= 1)")
    dev = q.device
    _build.check("q", q, q.dtype, tuple(q.shape), dev)
    if q.shape[0] != b:
        raise ValueError(f"q batch {q.shape[0]} != k batch {b}")
    _build.check("k", k, q.dtype, (b, t, kvh, hd), dev)
    _build.check("v", v, q.dtype, (b, t, kvh, v.shape[3]), dev)


# ------------------------------------------------------------ decode

def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version of ``decode_attention`` (the reference's
    ``kernels/ref.py::decode_attention``)."""
    plain_runs["decode_attention"] += 1
    b, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd).float()
    logits = torch.einsum("bngd,btnd->bngt", qg, k.float()) * hd ** -0.5
    logits = torch.where(valid[:, None, None, :], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngt,btnd->bngd", w, v.float())
    return out.reshape(b, h, hd)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); k/v (B, T, KV, hd); valid (B, T) bool -> (B, H, hd)
    f32.  ``valid`` may be a broadcast view (of the cache's (T,) position
    mask, say): it is made contiguous here."""
    _check_qkv(q, k, v, 3)
    b, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if v.shape[3] != hd:
        raise ValueError(f"v head dim {v.shape[3]} != q/k head dim {hd}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, t):
        raise ValueError(f"valid must be ({b}, {t}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    dev = q.device
    valid = valid.contiguous()
    _build.check("valid", valid, torch.bool, (b, t), dev)
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, valid)
    _build.require_cuda(dev, "decode_attention")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:            # nothing to attend: no launch
        return out
    g = h // kvh
    chunks = -(-t // DECODE_CHUNK)
    m = torch.empty((b, kvh, chunks, g), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, kvh, chunks, g, hd), dtype=torch.float32,
                      device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().decode_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(valid), _DTYPES[q.dtype], b, t, h,
            kvh, hd, DECODE_CHUNK, hd ** -0.5, ptr(m), ptr(l), ptr(acc),
            ptr(out), _build.stream(dev))
    _build.raise_on(err, "decode_attention")
    launches["decode_attention"] += 1
    return out


# ------------------------------------------------------------- flash

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention`` (the reference's
    ``kernels/ref.py::flash_attention``: the (B, KV, S, G, T) logits
    materialised)."""
    plain_runs["flash_attention"] += 1
    b, s, h, hd = q.shape
    t, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, h // kvh, hd).float()
    logits = torch.einsum("bsngd,btnd->bnsgt", qg, k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = (j <= i) if causal else torch.ones((s, t), dtype=torch.bool,
                                              device=q.device)
    if window:
        mask = mask & (i - j < window)
    logits = torch.where(mask[None, None, :, None, :], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnsgt,btnd->bsngd", w, v.float())
    return out.reshape(b, s, h, hdv).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv) ->
    (B, S, H, hdv) in q's dtype.  H = KV * G (grouped-query attention)."""
    _check_qkv(q, k, v, 4)
    b, s, h, hd = q.shape
    t, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be "
                         f">= 0")
    dev = q.device
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    _build.require_cuda(dev, "flash_attention")
    out = torch.empty((b, s, h, hdv), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:            # nothing to attend: no launch
        return out
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(out), _DTYPES[q.dtype], b, s, t, h,
            kvh, hd, hdv, int(causal), int(window), float(softcap),
            hd ** -0.5 if scale is None else float(scale),
            _build.stream(dev))
    _build.raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/attention.cu`` with its two launchers declared."""
    lib = _build.load("attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p] * 4 + [i] * 10 + [f, f, p]
    lib.decode_attention_launch.argtypes = [p] * 4 + [i] * 7 + [f] + [p] * 5
    for fn in (lib.flash_attention_launch, lib.decode_attention_launch):
        fn.restype = i
    return lib
