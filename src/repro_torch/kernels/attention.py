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
    (B, T) validity mask, scale ``hd ** -0.5``, an optional tanh soft cap
    after the scale and before the mask (the reference model's ``_sdpa``
    order; the TPU kernel has none), output (B, H, hd) f32.  Bound by
    device-memory bytes.  Flash-decoding: ``decode_partial_kernel``
    gives a block to (b, KV head, ``decode_chunk`` keys) and streams the
    chunk's K tiles, then its V tiles, through a ring of 16-byte
    ``cp.async`` copies with two tiles always in flight (tens of KB an
    SM); in bf16 with G <= 16 and hd a multiple of 64
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

Gradients: ``flash_attention`` applies ``FlashAttention``, a
``torch.autograd.Function`` whose forward is the launch above and whose
backward is ``flash_attention_backward``.  When an input needs a
gradient, the forward also keeps each row's log-sum-exp (the kernels'
epilogue stores ``m + log2(l)``, base 2, (B, S, H) f32; serving runs
under ``no_grad`` and stores none), and the backward reads P from it
instead of recomputing it.  On CUDA tensors the backward is the
hand-written kernels of ``csrc/attention_bwd.cu``: a dQ kernel that also
writes ``D = rowsum(dO * O)``, then a dK/dV kernel that sums the G heads
of a group inside its block (no atomics: gradients equal bit for bit
from run to run); bf16 on the tensor cores (``wgmma``: S, dP, dQ, dK and
dV with P and dS rounded to bf16 as A operands, f32 sums), f32 on the
CUDA cores, register-tiled.  On CPU tensors it is the explicit formula
``flash_attention_backward_plain`` (``flash_lse_plain`` for the
log-sum-exp, ``torch.logsumexp`` over the masked logits).  Masked logits
are constants (-2e38), so no gradient flows through them; a row with no
valid key gives each key's dV ``dO / T`` and nothing to q or k, as
autograd through the plain version does, and never reads its
log-sum-exp.  ``decode_attention`` has no backward and raises when grad
mode is on and an input requires grad, so that no gradient is dropped
without a word.

Dtypes: q, k, v float32 or bfloat16, all one type; f32 accumulation.
On CUDA tensors each wrapper launches its kernel (and adds one to its
entry of ``launches``) or raises; on CPU tensors it runs its plain
version (and adds one to ``plain_runs``); on ``meta`` tensors it returns
empty outputs of the kernel's shapes, dtypes and layout and adds to
neither (a count, ``roofline.op_cost``, not a result).  Each wrapper
charges its function's work (``roofline.kernel_work``) to an active op
counter, the same on every device, and the ops inside it are not
counted.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build
from ._build import supported  # noqa: F401
from ..roofline import kernel_work, op_cost

NEG = -2.0e38
LOG2E = 1.4426950408889634   # the kernels' softmax runs in base 2
MAX_HEAD_DIM = 256
MAX_GROUP = 64              # query heads per KV head a kernel block holds
HEAD_ALIGN = 16             # head dims the kernels take are multiples
DECODE_MAX_CHUNK = 256      # keys a decode block takes at most, as in C
WRAPPERS = ("decode_attention", "decode_attention_with_lse",
            "flash_attention", "flash_attention_backward")
# the launches (plain runs) of the two flash wrappers with a query offset
# q_start > 0, counted in their wrapper's entry too
OFFSET_COUNTS = ("flash_attention_q_start",
                 "flash_attention_backward_q_start")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each wrapper's kernel since the last ``reset_launches``,
# and runs of each plain version (which never count as launches).
launches: Dict[str, int] = dict.fromkeys(WRAPPERS + OFFSET_COUNTS, 0)
plain_runs: Dict[str, int] = dict.fromkeys(WRAPPERS + OFFSET_COUNTS, 0)


def reset_launches() -> None:
    for k in WRAPPERS + OFFSET_COUNTS:
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
                           v: torch.Tensor, valid: torch.Tensor, *,
                           softcap: float = 0.0, with_lse: bool = False):
    """Plain PyTorch version of ``decode_attention`` (the reference's
    ``kernels/ref.py::decode_attention``, with the soft cap of the
    reference model's ``_sdpa``); ``with_lse`` also returns each head's
    base-2 log-sum-exp over its masked logits (B, H) f32, as
    ``decode_attention_with_lse``."""
    plain_runs["decode_attention_with_lse" if with_lse
               else "decode_attention"] += 1
    b, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd).float()
    logits = torch.einsum("bngd,btnd->bngt", qg, k.float()) * hd ** -0.5
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(valid[:, None, None, :], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngt,btnd->bngd", w, v.float()).reshape(b, h, hd)
    if not with_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, h) * LOG2E


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, softcap: float = 0.0,
                     valid_count: Optional[int] = None) -> torch.Tensor:
    """q (B, H, hd); k/v (B, T, KV, hd); valid (B, T) bool -> (B, H, hd)
    f32.  ``valid`` may be a broadcast view (of the cache's (T,) position
    mask, say): it is made contiguous here.  ``softcap`` > 0 caps each
    scaled logit to ``softcap * tanh(logit / softcap)``.  On ``meta``,
    where ``valid`` holds no data, ``valid_count`` (its True entries)
    says what the op counter charges; elsewhere the count is read from
    ``valid``."""
    return _decode_call(q, k, v, valid, softcap, valid_count, False)


def decode_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, valid: torch.Tensor, *,
                              softcap: float = 0.0,
                              valid_count: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention``'s output and each head's base-2 log-sum-exp
    over its masked logits (B, H) f32 (``decode_combine_kernel<true>``),
    from which outputs over disjoint blocks of the keys merge into the
    output over all of them (``combine_decode``): the decode of a cache
    whose sequence is sharded over ranks."""
    return _decode_call(q, k, v, valid, softcap, valid_count, True)


def combine_decode(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The decode output over the union of N disjoint blocks of keys from
    each block's ``decode_attention_with_lse``: ``outs`` (N, B, H, hd) and
    ``lses`` (N, B, H) f32, weights ``2^(lse_i - max)`` normalised (a
    block with no valid key has an lse near -2e38 and weight 0 beside one
    that has)."""
    w = torch.softmax(lses * (1.0 / LOG2E), dim=0)
    return (w[..., None] * outs).sum(0)


def _decode_call(q, k, v, valid, softcap: float,
                 valid_count: Optional[int], with_lse: bool):
    _check_qkv(q, k, v, 3)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise RuntimeError("decode_attention has no backward: call it "
                           "under torch.no_grad() or on inputs that do "
                           "not require grad")
    b, h, hd = q.shape
    t = k.shape[1]
    if v.shape[3] != hd:
        raise ValueError(f"v head dim {v.shape[3]} != q/k head dim {hd}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, t):
        raise ValueError(f"valid must be ({b}, {t}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if softcap < 0:
        raise ValueError(f"softcap {softcap} must be >= 0")
    meta = q.device.type == "meta"
    if meta and valid_count is None:
        raise ValueError("decode_attention on meta needs valid_count: "
                         "valid holds no data there")
    name = "decode_attention_with_lse" if with_lse else "decode_attention"
    work = lambda: kernel_work.attention_work(
        "decode_attention", (q, k, v, valid), {},
        n_valid=valid_count if meta else None, with_lse=with_lse)
    with op_cost.charge(name, work):
        return _decode_attention(q, k, v, valid, softcap, with_lse)


def _decode_attention(q, k, v, valid, softcap: float, with_lse: bool):
    """``decode_attention`` past its checks: the kernel, the plain
    version on the CPU, or on ``meta`` an empty output; with
    ``with_lse`` a pair (output, log-sum-exp)."""
    b, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type == "meta":
        out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
        return (out, torch.empty((b, h), dtype=torch.float32, device=dev)
                ) if with_lse else out
    valid = valid.contiguous()
    _build.check("valid", valid, torch.bool, (b, t), dev)
    if dev.type == "cpu":       # laid out as the kernel's output
        res = decode_attention_plain(q, k, v, valid, softcap=softcap,
                                     with_lse=with_lse)
        return tuple(x.contiguous() for x in res) if with_lse \
            else res.contiguous()
    _build.require_cuda(dev, "decode_attention")
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    lse = (torch.empty((b, h), dtype=torch.float32, device=dev)
           if with_lse else None)
    if b == 0 or h == 0:            # nothing to attend: no launch
        return (out, lse) if with_lse else out
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
            kvh, hdp, chunk, scale, float(softcap), ptr(m), ptr(l),
            ptr(acc), ptr(res), ptr(lse), _build.stream(dev))
    _build.raise_on(err, "decode_attention")
    launches["decode_attention_with_lse" if with_lse
             else "decode_attention"] += 1
    if res is not out:
        out.copy_(res[..., :hd])
    return (out, lse) if with_lse else out


# ------------------------------------------------------------- flash

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          scale: Optional[float] = None,
                          q_start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention`` (the reference's
    ``kernels/ref.py::flash_attention``: the (B, KV, S, G, T) logits
    materialised)."""
    _count(plain_runs, "flash_attention", q_start)
    b, s, h, _ = q.shape
    logits, _, mask = _flash_logits(q, k, causal, window, softcap, scale,
                                    q_start)
    w = torch.softmax(torch.where(mask, logits, NEG), dim=-1)
    out = torch.einsum("bnsgt,btnd->bsngd", w, v.float())
    return out.reshape(b, s, h, v.shape[3]).to(q.dtype)


def _count(counts: Dict[str, int], name: str, q_start: int) -> None:
    counts[name] += 1
    if q_start:
        counts[name + "_q_start"] += 1


def _flash_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int, softcap: float, scale: Optional[float],
                  q_start: int = 0):
    """(logits (B, KV, S, G, T) f32 after the scale and the soft cap,
    the cap's tanh or None, the (1, 1, S, 1, T) mask of valid keys; row
    i at position ``q_start + i``)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, h // kvh, hd).float()
    logits = torch.einsum("bsngd,btnd->bnsgt", qg, k.float()) * scale
    th = None
    if softcap:
        th = torch.tanh(logits / softcap)
        logits = softcap * th
    i = torch.arange(q_start, q_start + s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = (j <= i) if causal else torch.ones((s, t), dtype=torch.bool,
                                              device=q.device)
    if window:
        mask = mask & (i - j < window)
    return logits, th, mask[None, None, :, None, :]


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    scale: Optional[float] = None,
                    q_start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the log-sum-exp the flash forward keeps:
    ``torch.logsumexp`` over each row's masked logits, in base 2 as the
    kernels store it (divided by ln 2), (B, S, H) f32.  A row with no
    valid key gets about -2.9e38 here and about -2e38 from a kernel; the
    backward never reads it."""
    b, s, h, _ = q.shape
    logits, _, mask = _flash_logits(q, k, causal, window, softcap, scale,
                                    q_start)
    lse = torch.logsumexp(torch.where(mask, logits, NEG), dim=-1) * LOG2E
    return lse.permute(0, 2, 1, 3).reshape(b, s, h).contiguous()


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, softcap: float, q_start: int = 0) -> None:
    _check_qkv(q, k, v, 4)
    h, kvh = q.shape[2], k.shape[2]
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if window < 0 or softcap < 0 or q_start < 0:
        raise ValueError(f"window {window}, softcap {softcap} and q_start "
                         f"{q_start} must be >= 0")


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward launch (or plain
    version), which keeps the log-sum-exp when ``with_lse`` (an input
    needs a gradient), and ``flash_attention_backward`` on the saved q,
    k, v, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, with_lse,
                q_start):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                  q_start=q_start)
        out, lse = _flash_forward(q, k, v, with_lse=with_lse, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, lse,
                                              **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_start: int = 0) -> torch.Tensor:
    """q (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hdv) ->
    (B, S, H, hdv) in q's dtype.  H = KV * G (grouped-query attention).
    Row i of q is at position ``q_start + i`` for the masks (a
    context-parallel rank's block of rows of a longer query against all T
    keys: rows [a, b) of a call equal the call on rows [a, b) with
    ``q_start = a``).  Differentiable in q, k and v
    (``FlashAttention``)."""
    _check_flash(q, k, v, window, softcap, q_start)
    # ctx.needs_input_grad holds under no_grad too: ask grad mode here
    with_lse = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                with_lse, int(q_start))


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             scale: Optional[float] = None,
                             q_start: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s output and the base-2 log-sum-exp (B, S, H)
    f32 its backward reads (``flash_lse_plain`` on the CPU); one forward
    launch, no autograd."""
    _check_flash(q, k, v, window, softcap, q_start)
    return _flash_forward(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale, with_lse=True,
                          q_start=q_start)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int, softcap: float,
                   scale: Optional[float], with_lse: bool = False,
                   q_start: int = 0
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward of ``flash_attention`` and, ``with_lse``, its base-2
    log-sum-exp (else None): its kernel, on the CPU its plain versions,
    on ``meta`` empty outputs; charged to the op counter by formula."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_start=q_start)
    work = lambda: kernel_work.attention_work("flash_attention", (q, k, v),
                                              kw)
    with op_cost.charge("flash_attention", work):
        return _flash_launch(q, k, v, with_lse=with_lse, **kw)


def _flash_launch(q, k, v, *, causal: bool, window: int, softcap: float,
                  scale: Optional[float], with_lse: bool, q_start: int
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    b, s, h, hd = q.shape
    t, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_start=q_start)
    if dev.type == "cpu":       # laid out as the kernel's outputs
        return (flash_attention_plain(q, k, v, **kw).contiguous(),
                flash_lse_plain(q, k, **kw) if with_lse else None)
    if dev.type != "meta":
        _build.require_cuda(dev, "flash_attention")
    out = torch.empty((b, s, h, hdv), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=dev)
           if with_lse else None)
    if b == 0 or s == 0 or dev.type == "meta":   # no launch
        return out, lse
    scale = hd ** -0.5 if scale is None else float(scale)
    q, k, v = (_aligned(pad_head_dim(x)) for x in (q, k, v))
    hdp, hdvp = q.shape[-1], v.shape[-1]
    res = out if hdvp == hdv else torch.empty((b, s, h, hdvp),
                                              dtype=q.dtype, device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(res), ptr(lse), _DTYPES[q.dtype], b,
            s, t, h, kvh, hdp, hdvp, int(causal), int(window), int(q_start),
            float(softcap), scale, _build.stream(dev))
    _build.raise_on(err, "flash_attention")
    _count(launches, "flash_attention", q_start)
    if res is not out:
        out.copy_(res[..., :hdv])
    return out, lse


# ---------------------------------------------------- flash backward

def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   dout: torch.Tensor,
                                   lse: Optional[torch.Tensor] = None, *,
                                   causal: bool = True, window: int = 0,
                                   softcap: float = 0.0,
                                   scale: Optional[float] = None,
                                   q_start: int = 0):
    """Plain PyTorch version of ``flash_attention_backward``: the explicit
    formula over the materialised (B, KV, S, G, T) logits, P under the
    reference's -2e38 masks (the softmax, or ``2^(logit * log2(e) -
    lse)`` from the forward's base-2 ``lse`` where given, 1/T over all
    keys in a row with no valid key), ``D = rowsum(dO * O)``, and the
    soft cap's derivative ``1 - tanh^2``."""
    _count(plain_runs, "flash_attention_backward", q_start)
    b, s, h, hd = q.shape
    t, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, g, hd).float()
    kf, vf = k.float(), v.float()
    logits, th, mask = _flash_logits(q, k, causal, window, softcap, scale,
                                     q_start)
    if lse is None:
        p = torch.softmax(torch.where(mask, logits, NEG), dim=-1)
    else:
        lse_r = lse.reshape(b, s, kvh, g).permute(0, 2, 1, 3)[..., None]
        p = torch.where(mask, torch.exp2(logits * LOG2E - lse_r), 0.0)
        p = torch.where(mask.any(-1, keepdim=True), p, 1.0 / t)
    dog = dout.reshape(b, s, kvh, g, hdv).float()
    dv = torch.einsum("bnsgt,bsngd->btnd", p, dog)
    dp = torch.einsum("bsngd,btnd->bnsgt", dog, vf)
    dsum = (dog * o.reshape(b, s, kvh, g, hdv).float()).sum(-1)
    ds = torch.where(mask, p * (dp - dsum.permute(0, 2, 1, 3)[..., None]),
                     0.0)
    if softcap:
        ds = ds * (1 - th * th)
    ds = ds * scale
    dq = torch.einsum("bnsgt,btnd->bsngd", ds, kf).reshape(b, s, h, hd)
    dk = torch.einsum("bnsgt,bsngd->btnd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             dout: torch.Tensor,
                             lse: Optional[torch.Tensor] = None, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0,
                             scale: Optional[float] = None,
                             q_start: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` whose output is ``o``,
    given the output's gradient ``dout`` (B, S, H, hdv) and the forward's
    base-2 log-sum-exp ``lse`` (B, S, H) f32 (``flash_attention_with_lse``;
    required on the card, recomputed by the plain version when None);
    each in its input's dtype and shape."""
    _check_flash(q, k, v, window, softcap, q_start)
    b, s, h, hd = q.shape
    t, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    dout = dout.contiguous()
    for name, x in (("o", o), ("dout", dout)):
        _build.check(name, x.contiguous(), q.dtype, (b, s, h, hdv), dev)
    if lse is not None:
        _build.check("lse", lse, torch.float32, (b, s, h), dev)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_start=q_start)
    work = lambda: kernel_work.flash_backward_work(q, k, v, kw)
    with op_cost.charge("flash_attention_backward", work):
        if dev.type == "cpu":   # laid out as the kernel's outputs
            return tuple(x.contiguous() for x in
                         flash_attention_backward_plain(q, k, v, o, dout,
                                                        lse, **kw))
        if dev.type == "meta":
            return tuple(torch.empty_like(
                x, memory_format=torch.contiguous_format) for x in (q, k, v))
        return _backward_launch(q, k, v, o, dout, lse, **kw)


def _backward_launch(q, k, v, o, dout, lse, *, causal: bool, window: int,
                     softcap: float, scale: Optional[float], q_start: int):
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dev = q.device
    _build.require_cuda(dev, "flash_attention_backward")
    if lse is None:
        raise ValueError("flash_attention_backward on the card reads the "
                         "forward's log-sum-exp: pass lse "
                         "(flash_attention_with_lse)")
    dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                  for x in (q, k, v))
    if b == 0 or s == 0:            # no query: no gradient, no launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    scale = hd ** -0.5 if scale is None else float(scale)
    q, k, v, o, dout = (_aligned(pad_head_dim(x)) for x in (q, k, v, o, dout))
    hdp, hdvp = q.shape[-1], v.shape[-1]
    rq, rk, rv = (x if x.shape[-1] == y.shape[-1] else torch.empty_like(y)
                  for x, y in ((dq, q), (dk, k), (dv, v)))
    dvec = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _bwd_lib().flash_attention_backward_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(dout), ptr(lse), ptr(rq),
            ptr(rk), ptr(rv), ptr(dvec), _DTYPES[q.dtype], b, s, t, h, kvh,
            hdp, hdvp, int(causal), int(window), int(q_start),
            float(softcap), scale, _build.stream(dev))
    _build.raise_on(err, "flash_attention_backward")
    _count(launches, "flash_attention_backward", q_start)
    for res, out in ((rq, dq), (rk, dk), (rv, dv)):
        if res is not out:
            out.copy_(res[..., :out.shape[-1]])
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The built ``csrc/attention_bwd.cu`` with its launcher declared."""
    lib = _build.load("attention_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_backward_launch.argtypes = (
        [p] * 10 + [i] * 11 + [f, f, p])
    lib.flash_attention_backward_launch.restype = i
    return lib


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
    lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 11 + [f, f, p]
    lib.decode_attention_launch.argtypes = [p] * 4 + [i] * 7 + [f, f] + [p] * 6
    lib.decode_max_chunk.argtypes = []
    for fn in (lib.flash_attention_launch, lib.decode_attention_launch,
               lib.decode_max_chunk):
        fn.restype = i
    if lib.decode_max_chunk() != DECODE_MAX_CHUNK:
        raise RuntimeError(f"attention.cu takes chunks of at most "
                           f"{lib.decode_max_chunk()} keys, the wrapper "
                           f"{DECODE_MAX_CHUNK}")
    return lib
