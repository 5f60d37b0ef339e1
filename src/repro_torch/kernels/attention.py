"""The two attention kernels: hand-written CUDA kernels of
``csrc/attention.cu`` and their plain PyTorch versions.

  * ``flash_attention`` replaces ``_flash_kernel`` of
    ``src/repro/kernels/flash_attn.py`` (:47, called at :128): forward
    attention of q (B, S, H, hd) against k (B, T, KV, hd) and v (B, T, KV,
    hdv) with an online softmax in f32: grouped-query heads (head h reads
    KV head h // G, H = KV * G), causal ``kpos <= qpos``, a sliding window
    ``qpos - kpos < window``, a tanh soft cap ``softcap * tanh(x /
    softcap)`` after the scale (``hd ** -0.5`` by default), and hdv != hd.
    The output is (B, S, H, hdv) in q's dtype.  Bound by operations.  One
    entry point, two designs: bf16 runs ``flash_kernel_bf16`` on the
    tensor cores (``wgmma.mma_async`` bf16 -> f32: S = Q K^T with both
    operands in swizzled shared tiles, O += P V with P from registers and
    V through the transposed descriptor; the softmax in the accumulator
    registers, P rounded to bf16 there; two warpgroups of 64 rows a
    block, K and V double-buffered); f32 runs ``flash_kernel_f32`` on the
    CUDA cores in full f32 (TF32 would not hold the f32 tolerances),
    register-tiled like an SGEMM (8 rows x 4 keys of scores and 8 rows x
    hd/16 columns of output a thread, 16-byte shared loads) against its
    shared-memory bandwidth.  Both give a block the G heads of one KV head
    for a run of query positions, so each K/V tile is read once for the
    group, bring K and V in by 16-byte ``cp.async`` while the products
    run, and skip the tiles the masks remove.
  * ``decode_attention`` replaces ``_decode_kernel`` of
    ``src/repro/kernels/decode_attn.py`` (:26, called at :87): one query
    token per sequence, q (B, H, hd) against k/v (B, T, KV, hd) under a
    (B, T) validity mask, scale ``hd ** -0.5``, no soft cap, output (B, H,
    hd) f32.  Bound by device-memory bytes.  Flash-decoding:
    ``decode_partial_kernel`` gives a block to (b, KV head, ``decode_chunk``
    keys) and streams the chunk's K tiles, then its V tiles, through a
    ring of 16-byte ``cp.async`` copies with two tiles always in flight
    (tens of KB an SM); in bf16 with G <= 16 and hd a multiple of 64
    both products run on the tensor cores (``decode_partial_kernel_tc``,
    ``mma.sync``), otherwise on the CUDA cores (a few lanes a key for the
    logits of all G heads, a thread 4 value columns of every head for
    P V); ``decode_combine_kernel`` merges the chunks and divides by
    ``max(l, 1e-30)``.

Head dims that are not a multiple of 16 are zero-padded to one before a
launch (``pad_head_dim``; a zero column changes no dot product) and the
output is sliced back: a layout step around the kernel, not a fallback.

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
MAX_HEAD_DIM = 256
MAX_GROUP = 64              # query heads per KV head a kernel block holds
HEAD_ALIGN = 16             # head dims the kernels take are multiples
DECODE_MAX_CHUNK = 256      # keys a decode block takes at most, as in C
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


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last (head) dim zero-padded to a multiple of
    ``HEAD_ALIGN``, contiguous; ``x`` itself if it is one already."""
    pad = -x.shape[-1] % HEAD_ALIGN
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.contiguous()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its storage does not start on the 16
    bytes the kernels' vector copies need (a view with an offset)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def decode_chunk(t: int, pairs: int, group: int, sms: int) -> int:
    """Keys a ``decode_partial_kernel`` block takes: T split into enough
    chunks that the ``pairs`` = B * KV (batch, KV head) pairs give at
    least 2 blocks on each of the card's ``sms`` multiprocessors (each
    block keeps 2 tiles of 32 keys of K or V in flight, 16 KB in f32 at hd
    128, so an SM holds 32 KB or more), at most ``DECODE_MAX_CHUNK`` keys and
    at most 32 KB of the chunk's logits for the ``group`` = G heads; a
    multiple of 16, at least 16."""
    cap = max(16, min(DECODE_MAX_CHUNK, 8192 // max(group, 1) // 16 * 16))
    per_pair = -(-2 * sms // max(pairs, 1))
    chunk = -(-t // per_pair) // 16 * 16
    return max(16, min(cap, chunk))


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
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:            # nothing to attend: no launch
        return out
    scale = hd ** -0.5
    q, k, v = (_aligned(pad_head_dim(x)) for x in (q, k, v))
    hdp = q.shape[-1]
    g = h // kvh
    chunk = decode_chunk(t, b * kvh, g, _sms(dev))
    chunks = -(-t // chunk)
    m = torch.empty((b, kvh, chunks, g), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, kvh, chunks, g, hdp), dtype=torch.float32,
                      device=dev)
    res = out if hdp == hd else torch.empty((b, h, hdp),
                                            dtype=torch.float32, device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().decode_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(valid), _DTYPES[q.dtype], b, t, h,
            kvh, hdp, chunk, scale, ptr(m), ptr(l), ptr(acc), ptr(res),
            _build.stream(dev))
    _build.raise_on(err, "decode_attention")
    launches["decode_attention"] += 1
    if res is not out:
        out.copy_(res[..., :hd])
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
    scale = hd ** -0.5 if scale is None else float(scale)
    q, k, v = (_aligned(pad_head_dim(x)) for x in (q, k, v))
    hdp, hdvp = q.shape[-1], v.shape[-1]
    res = out if hdvp == hdv else torch.empty((b, s, h, hdvp),
                                              dtype=q.dtype, device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(res), _DTYPES[q.dtype], b, s, t, h,
            kvh, hdp, hdvp, int(causal), int(window), float(softcap), scale,
            _build.stream(dev))
    _build.raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    if res is not out:
        out.copy_(res[..., :hdv])
    return out


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/attention.cu`` with its two launchers declared;
    raises if its chunk cap is not ``DECODE_MAX_CHUNK``."""
    lib = _build.load("attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p] * 4 + [i] * 10 + [f, f, p]
    lib.decode_attention_launch.argtypes = [p] * 4 + [i] * 7 + [f] + [p] * 5
    lib.decode_max_chunk.argtypes = []
    for fn in (lib.flash_attention_launch, lib.decode_attention_launch,
               lib.decode_max_chunk):
        fn.restype = i
    if lib.decode_max_chunk() != DECODE_MAX_CHUNK:
        raise RuntimeError(f"attention.cu takes chunks of at most "
                           f"{lib.decode_max_chunk()} keys, the wrapper "
                           f"{DECODE_MAX_CHUNK}")
    return lib
