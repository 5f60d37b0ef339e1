"""The work of the attention kernels' functions by formula, from the
shapes of a call: a copy of the program's ``roofline/kernel_work.py``
(``attended_pairs``, ``attention_work``, ``flash_backward_work``) that
takes sizes instead of tensors.  Each input byte is counted read once
and each output byte written once; the FLOPs are 2 a multiply-add of
Q K^T and of P V over the (query, key) pairs the masks let through.
Returns (bytes, FLOPs)."""
from __future__ import annotations

from typing import Tuple


def attended_pairs(s: int, t: int, causal: bool = True, window: int = 0,
                   q_start: int = 0) -> int:
    """(query, key) pairs a (batch, head) attends: query row r at
    position i = q_start + r sees key j when j <= i (causal) and
    i - j < window (window > 0)."""
    total = 0
    for i in range(q_start, q_start + s):
        hi = min(i, t - 1) if causal else t - 1
        lo = max(i - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_work(b: int, s: int, t: int, h: int, kvh: int, hd: int,
               hdv: int, causal: bool = True, window: int = 0,
               elem: int = 4) -> Tuple[float, float]:
    """One flash forward over q (b, s, h, hd), k (b, t, kvh, hd), v (b, t,
    kvh, hdv): q, k, v and the output once, 2 (hd + hdv) FLOPs a pair."""
    pairs = b * h * attended_pairs(s, t, causal, window)
    n_bytes = (b * s * h * hd + b * t * kvh * (hd + hdv)
               + b * s * h * hdv) * elem
    return float(n_bytes), float(2 * pairs * (hd + hdv))


def decode_work(b: int, h: int, kvh: int, hd: int, cache: int,
                n_valid: int, elem: int = 4) -> Tuple[float, float]:
    """One decode over q (b, h, hd) and a cache of ``cache`` slots a row
    of which ``n_valid`` entries in all are valid: q, the valid keys and
    values, the (b, cache) mask and the f32 output once."""
    n_bytes = ((b * h * hd + 2 * n_valid * kvh * hd) * elem + b * cache
               + b * h * hd * 4)
    return float(n_bytes), float(4 * n_valid * h * hd)


def flash_backward_work(b: int, s: int, t: int, h: int, kvh: int, hd: int,
                        hdv: int, causal: bool = True, window: int = 0,
                        elem: int = 4) -> Tuple[float, float]:
    """One flash backward: q, k, v, the output and its gradient read
    once and dq, dk, dv written once, against 2.5 times the forward's
    FLOPs (the recomputed scores, dP, dS and the three products)."""
    pairs = b * h * attended_pairs(s, t, causal, window)
    n_bytes = 2 * (b * s * h * hd + b * t * kvh * (hd + hdv)
                   + b * s * h * hdv) * elem
    return float(n_bytes), float(2.5 * 2 * pairs * (hd + hdv))
