"""The work of each hand-written kernel's function, by formula: the one
count that the kernel's wrapper charges the op counter (``op_cost``)
and that ``chip_smoke.py`` sets the kernel's measured time against.

A dispatch mode cannot see a launch through ctypes, and on the CPU the
plain version's ops would charge work the kernel never does (a dense
S x T score matrix, a Python loop over a cache set's requests), so each
wrapper charges the work of its function instead, the same whatever
implements it.  Each formula counts the bytes the function must move
(each input read once, each output written once) and its operations;
where the work depends on the data (the keys a mask lets through, the
active requests of a packed batch, the sets a batch touches) it counts
what these inputs need, not the most they could.

  * ``attention_work``: the flash forward (2 FLOPs a multiply-add of
    Q K^T and of P V over the pairs the masks let through,
    ``attended_pairs``) and the decode (the same over the valid keys);
  * ``flash_backward_work``: 2.5 times the forward's FLOPs, q, k, v, the
    output and its gradient read once, dq, dk, dv written once;
  * ``scan_work``: the engine scans, about 4 lane operations a way and
    request (plus 3 hashes of 10 on the extended tier) of the active
    requests, counted against the f32 peak;
  * ``pool_work``: the pool kernels, about 4 operations a way, 6 a hash
    or segment and 1-2 a word read;
  * ``grouped_experts_work``: the MoE decode experts, 6 D F FLOPs a kept
    (token, slot) pair, each expert hit's three matrices read once.

``bound_ms`` turns a ``Work`` into the least milliseconds on ``chip``
and what bounds it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .hw import CHIP, H100


class Work(NamedTuple):
    bytes: float
    ops: float
    dtype: torch.dtype = torch.float32   # the peak its operations run at


def bound_ms(work: Work, chip: H100 = CHIP) -> Tuple[float, str]:
    """(least ms, ``"bytes"`` or ``"operations"``): bytes over the memory
    rate against operations over the peak of the work's dtype, the
    larger."""
    t_bytes = work.bytes / chip.hbm_Bps * 1e3
    t_ops = work.ops / chip.peak_flops(work.dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attended_pairs(s: int, t: int, causal: bool, window: int,
                   q_start: int = 0) -> int:
    """(query, key) pairs the masks let through, per (batch, head): query
    row r, at position i = ``q_start + r``, sees key j when ``j <= i``
    (causal) and ``i - j < window`` (window > 0), counted a query row at
    a time."""
    i = torch.arange(q_start, q_start + s, dtype=torch.int64)
    hi = torch.clamp(i, max=t - 1) if causal else torch.full_like(i, t - 1)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int((hi - lo + 1).clamp(min=0).sum())


def attention_work(name: str, args, kwargs, n_valid: Optional[int] = None,
                   with_lse: bool = False) -> Work:
    """One call of ``flash_attention`` (args q, k, v; ``kwargs`` its
    masks and ``q_start``) or ``decode_attention`` (args q, k, v, valid;
    ``n_valid`` the valid entries of ``valid``, read from it when None;
    ``with_lse`` its (B, H) f32 log-sum-exp written too): q, the keys and
    values it attends to, the mask and the output, each once, and its
    FLOPs at the peak of the input type."""
    q = args[0]
    es = q.element_size()
    if name == "flash_attention":
        _, k, v = args[:3]
        b, s, h, hd = q.shape
        t, hdv = k.shape[1], v.shape[3]
        pairs = b * h * attended_pairs(s, t, kwargs.get("causal", True),
                                       kwargs.get("window", 0),
                                       kwargs.get("q_start", 0))
        n_bytes = (q.numel() + k.numel() + v.numel() + b * s * h * hdv) * es
        flops = 2 * pairs * (hd + hdv)
    else:
        _, k, v, valid = args[:4]
        b, h, hd = q.shape
        kvh = k.shape[2]
        if n_valid is None:
            n_valid = int(valid.sum())
        n_bytes = ((q.numel() + 2 * n_valid * kvh * hd) * es + valid.numel()
                   + b * h * (hd + with_lse) * 4)
        flops = 4 * n_valid * h * hd
    return Work(n_bytes, flops, q.dtype)


def flash_backward_work(q, k, v, kwargs) -> Work:
    """One flash backward: q, k, v, the output and its gradient read once
    and dq, dk, dv written once, against 2.5 times the forward's FLOPs."""
    b, s, h, hd = q.shape
    t, hdv = k.shape[1], v.shape[3]
    pairs = b * h * attended_pairs(s, t, kwargs.get("causal", True),
                                   kwargs.get("window", 0),
                                   kwargs.get("q_start", 0))
    n_bytes = 2 * (q.numel() + k.numel() + v.numel()
                   + b * s * h * hdv) * q.element_size()
    return Work(n_bytes, 2.5 * 2 * pairs * (hd + hdv), q.dtype)


def grouped_experts_work(x2, expert, keep, w_gate) -> Work:
    """One ``kernels.moe.grouped_experts`` call: x2, the routing and the
    (T, D) output once, the three (D x F) matrices of each expert that a
    kept pair names once, and 2 FLOPs a multiply-add of the kept pairs'
    three products (6 D F a pair)."""
    d, f = w_gate.shape[1], w_gate.shape[2]
    kept = expert[keep]
    es = x2.element_size()
    n_bytes = (2 * x2.numel() * es + expert.numel() * (8 + 4 + 1)
               + int(torch.unique(kept).numel()) * 3 * d * f * es)
    return Work(n_bytes, 6 * d * f * int(kept.numel()), x2.dtype)


def scan_work(tier: str, cols, ways: int, rows=None) -> Work:
    """One engine-scan dispatch over the (B, S, L) columns ``cols`` (tag,
    write, [level,] active) with the 1-byte mask, writing (B, S) rows of
    9 int and 5 float Stats; with state ``rows`` also those read once and
    written once.  Operations: about 4 a way and active request (the
    last column), plus 3 hashes of 10 on the extended tier."""
    b_s = cols[0].shape[0] * cols[0].shape[1]
    per_req = 4 * ways + (3 * 10 if tier == "ext" else 0)
    slots = cols[0].numel()
    in_bytes = sum(c.element_size() * c.numel() for c in cols) + slots
    out_bytes = b_s * (9 + 5) * 4
    row_bytes = 0 if rows is None else 2 * sum(
        x.element_size() * x.numel() for x in rows)
    return Work(in_bytes + out_bytes + row_bytes,
                int(cols[-1].sum()) * per_req)


def pool_work(name: str, args) -> Work:
    """One call of pool wrapper ``name`` on its positional ``args``: each
    input read once and each output written once (the block reads count
    only the rows they select, by this call's rows; the Bloom query one
    filter row and one mask row a query; the record the filter rows and
    counts of the sets this batch touches, read and written), against
    about 4 operations a way, 6 a hash or segment and 1-2 a word read."""
    if name == "tag_lookup":
        s, w = args[0].shape
        return Work(s * w * (4 + 1 + 4 + 4) + s * 12, 4 * s * w)
    if name == "lookup_fill":      # the store, plan and records; the rows
        tags, _, _, sets, _ = args              # of the sets asked about
        (s, w), k = tags.shape, len(sets)
        runs = np.unique(np.asarray(sets), return_counts=True)[1]
        r = min(4, int(runs.max(initial=0)))    # the pool's 4 rounds a batch
        return Work(s * w * 9 + (s + 1 + 2 * k) * 4 + k * 20
                    + len(runs) * w * 9, 4 * s * w * r)
    if name == "page_write":       # keys, the probed rows, pages in and out
        tags, _, data, level, _, sets, _, _ = args
        n, w, words = len(sets), tags.shape[1], data.shape[2]
        return Work(n * (8 + 5 * w + 8 * words + 8 * (level is not None)),
                    n * (2 * w + 6 * words))
    if name == "bloom_query":                  # (+ 4 B a row index)
        q, words = args[1].shape[0], args[0].shape[1]
        return Work(q * (words * 8 + 8 + 4 * (len(args) > 2
                                              and args[2] is not None)),
                    q * 3 * 6)
    if name == "bloom_record":
        bf1, _, _, sets, _, _ = args
        k, words = len(sets), bf1.shape[1]
        runs = len(np.unique(np.asarray(sets)))
        return Work(k * 4 + (2 * runs + 1) * 4
                    + runs * (2 * 2 * words * 4 + 2 * 4),
                    k * (3 * 6 + 6 * words))
    if name == "bdi_compress":
        n = args[0].shape[0]
        return Work(n * (128 + 136), n * 32 * 6)
    if name == "bdi_decompress":               # level, base, payload
        n, words = args[2].shape
        return Work(n * (8 + 8 * words), n * words * 2)
    if name == "read_rows":
        conv, ext, _, _, tier, set_idx, way = args
        n, words = tier.shape[0], conv.shape[2]
        read = 0                                # rows, + level/base on ext
        for t, store in enumerate((conv, ext)):
            ok = ((tier == t) & (set_idx >= 0) & (set_idx < store.shape[0])
                  & (way >= 0) & (way < store.shape[1]))
            read += int(ok.sum()) * (4 * words + 8 * t)
        return Work(n * (12 + 4 * words) + read, n * words * 2)
    s, _, words = args[0].shape
    if name == "gather_blocks":
        return Work(s * (4 + 8 * words), s * words)
    if name == "cached_block_read":
        return Work(s * (12 + 8 * words), s * words * 2)
    raise ValueError(f"no work formula for pool wrapper {name!r}")
