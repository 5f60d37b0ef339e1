"""The serving pool's mechanism kernels: hand-written CUDA kernels of
``csrc/pool.cu`` and their plain PyTorch versions.

  * ``tag_lookup`` (paper Algorithm 1) replaces ``_tag_lookup_kernel`` of
    ``src/repro/kernels/tag_lookup.py`` (:26, called at :57).  For every
    set ``s``: ``hit[s]`` is whether a valid way holds ``req[s]``,
    ``way[s]`` the first such way (0 on a miss, as ``argmax`` of an
    all-false row gives), and the new LRU row sets the hit way to
    ``LRU_MAX`` and decrements every other way, saturating at 0, on hit
    rows only.
  * ``lookup_fill`` is the reference pool's conventional tier for a whole
    batch (``src/repro/serving/paged_kv.py:221-253``: up to 4 rounds, each
    a ``tag_lookup`` over the whole store with tag 0 for the sets it does
    not ask about, then ``_conv_fill`` of each miss, ``:353``), in place.
    The wrapper orders the requests by set on the host (stably) and copies
    that plan once; it returns one record a request, read back once.
    Both run ``lookup_fill_kernel``: a lane holds 4 ways of a set (a
    uint4 of tags and of LRU counters and a word of valid bytes where the
    rows allow), a set of G = ceil(W / 4) groups takes next_pow2(G) lanes
    of a warp, the hit is a ballot and the way ``__ffs`` of it, and the
    LRU victim (the least counter, invalid ways first, the lowest way on
    ties) one segment-wide minimum of packed (counter, way) words.  A set
    replays its rounds in registers and writes back once.
  * ``bloom_query`` replaces ``_query_kernel`` of
    ``src/repro/kernels/bloom_query.py`` (:33, called at :69).  Query
    ``q`` hashes ``tags[q]`` with the ``NUM_HASHES`` multiply-shift hashes
    of ``core.bloom`` into bits of its filter row: ``pred[q]`` is whether
    all those bits are set, and ``masks[q]`` the row with exactly those
    bits set (an insert's OR-mask).  The reference takes the rows
    pre-gathered (``filters[q]``); given ``rows``, the kernel reads row
    ``rows[q]`` of the whole filter store itself (a row outside the store
    reads an empty filter).  ``bloom_query_kernel`` gives one thread to
    one query.
  * ``bloom_record`` replaces the reference pool's per-key
    ``_bloom_record`` (``src/repro/serving/paged_kv.py:390``: two
    ``bloom_query`` calls a key, the ORs and the MRU count on the host)
    for a whole batch of (set, tag) keys, in place and in batch order: the
    insert mask, ``in_bf2`` tested on bf2 before the OR, the mask ORed
    into both filters, ``n_mru[s] += 1`` unless ``in_bf2``, and the swap
    (bf1 = bf2, bf2 = 0, ``n_mru[s] = 0``) once ``n_mru[s] >= ways``.  The
    wrapper orders the keys by set on the host (a stable sort, so each
    set's keys keep their batch order) and ``bloom_record_kernel`` gives
    one warp to one set's run, with both filters and the count in
    registers; sets are independent, so the order across sets is free.
  * ``bdi_compress`` (paper §4.3.1) replaces ``_compress_kernel`` of
    ``src/repro/kernels/bdi.py`` (:28, called at :67).  A block is 32
    four-byte segments; segment 0 is the base and the mod-2^32 deltas of
    every segment from it give the level: ``HIGH`` when all fit int8 (as
    unsigned values, ``d <= 127`` or ``d >= 2^32 - 128``), ``LOW`` when
    they fit int16, else ``UNCOMP``; the payload is the deltas, or the raw
    block when ``UNCOMP``.  ``page_write`` is the reference pool's
    ``write_page`` after its routing (``paged_kv.py:293``: ``_probe``
    ``:339``, then ``bdi_compress`` and three ``.at[].set`` writes on the
    extended tier, a raw write otherwise) for N pages.  Both run
    ``page_write_kernel``, one warp a page: the probe is a ballot and
    ``__ffs``, the base comes from lane 0 by ``__shfl_sync`` and the fit
    tests are ``__all_sync`` votes; payload, level and base go straight
    into the store's (set, way) row.
  * ``gather_blocks``, the Indirect-MOV (§4.3.2), replaces
    ``_gather_kernel`` of ``src/repro/kernels/gather_blocks.py`` (:26,
    called at :47): the row ``way[s]`` of each set's (W, words) tile; a
    way outside [0, W) reads zeros, as the reference's one-hot select
    does.  ``cached_block_read`` is the reference's
    ``kernels/ops.py::cached_block_read`` (gather, then decompress) fused
    into one pass, and ``bdi_decompress`` (``_decompress_kernel``,
    ``bdi.py:45``, called at :87: ``base + payload`` mod 2^32, or the
    payload when ``UNCOMP``) is the same read over 1-way sets.
    ``read_rows`` is the pool's ``read_pages`` in one call: row ``n`` is
    ``conv[set, way]`` on tier 0, ``ext[set, way]`` restored with the
    level and base stored at ``[set, way]`` on tier 1, and zeros on tier
    2 or where the set or way lies outside its tier's store.  All four
    run ``block_read_kernel``: one warp an output row, lane = word, which
    reads only the selected row of the store in place and restores it on
    the way out.

Every kernel moves each byte once and is bound by device-memory bytes.
The reference tiles 256 sets (``tag_lookup``), 512 queries
(``bloom_query``), 256 blocks (BDI) and 64 sets (``gather_blocks``) per
program and asserts that the size is at most one tile or a multiple of
it; the kernels take any size (a bounds-checked grid, up to ``MAX_WAYS``
ways), so parity inputs keep to the sizes the reference accepts.  The
serving path calls them a few rows at a time, where a launch costs more
than its bytes: so one ``lookup_batch`` makes one ``lookup_fill``, one
``bloom_query`` and one ``bloom_record`` launch, one ``write_page`` one
``page_write`` launch and no read-back, and one ``read_pages`` one
``read_rows`` launch.

Dtypes: tags, LRU counters, requests, filter words, masks, blocks, bases
and payloads are int32 tensors holding the uint32 bit pattern; valid bits
are bool; ways and levels int32.  On CUDA tensors each wrapper launches
its kernel (and adds one to its entry of ``launches``) or raises; on CPU
tensors it runs its plain version (and adds one to ``plain_runs``).  An
active op counter (``roofline.op_cost``) is charged each call's work by
``roofline.kernel_work.pool_work``, whichever runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from ._build import supported  # noqa: F401
from .. import _u32
from ..core import bloom
from ..core.compression import HIGH, LOW, UNCOMP
from ..core.tag_store import LRU_MAX
from ..roofline import kernel_work, op_cost

SEGMENTS = 32
MAX_RECORD_WORDS = 256         # bloom_record_kernel: 8 words a lane
MAX_WAYS = 256                 # lookup_fill_kernel: 4 ways a lane, 2 x 32
ROUNDS = 4                     # the reference pool's conventional rounds a
#                                batch (one request a set a round)
REC_FIELDS = ("round", "hit", "way", "evicted", "victim_tag")
WRAPPERS = ("tag_lookup", "lookup_fill", "bloom_query", "bloom_record",
            "bdi_compress", "page_write", "bdi_decompress", "gather_blocks",
            "cached_block_read", "read_rows")

# Launches of each wrapper's kernel since the last ``reset_launches``,
# and runs of each plain version (which never count as launches).
launches: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)
plain_runs: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)


def _charged(name: str):
    """Charge each call of wrapper ``name`` to an active op counter by
    ``kernel_work.pool_work`` of its arguments, in signature order."""
    return op_cost.charged(
        lambda a: kernel_work.pool_work(name, tuple(a.values())))


def reset_launches() -> None:
    for k in WRAPPERS:
        launches[k] = plain_runs[k] = 0


# ----------------------------------------------------- lookup and fill

def _lookup(tags, valid, lru, req):
    """One round of Algorithm 1 over every set (``tag_lookup``)."""
    match = valid & (tags == req[:, None])
    hit = match.any(dim=1)
    way = match.to(torch.int32).argmax(dim=1).to(torch.int32)  # first index
    ways = torch.arange(tags.shape[1], device=tags.device)
    onehot = (ways == way[:, None]) & hit[:, None]
    new_lru = torch.where(onehot, LRU_MAX,
                          torch.where(hit[:, None], _u32.sat_dec(lru), lru))
    return hit.to(torch.int32), way, new_lru


def tag_lookup_plain(tags: torch.Tensor, valid: torch.Tensor,
                     lru: torch.Tensor, req: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``tag_lookup`` (same arguments)."""
    plain_runs["tag_lookup"] += 1
    return _lookup(tags, valid, lru, req)


def _check_store(name: str, tags, valid, lru=None) -> Tuple[int, int]:
    """(S, W) of a tier's (S, W) int32 tags, bool valid bits and, where
    given, int32 LRU counters, checked."""
    if tags.dim() != 2 or tags.shape[1] < 1:
        raise ValueError(f"{name}: tags must be (S, W) with W >= 1, got "
                         f"{tuple(tags.shape)}")
    s, w = tags.shape
    _build.check("tags", tags, torch.int32, (s, w), tags.device)
    _build.check("valid", valid, torch.bool, (s, w), tags.device)
    if lru is not None:
        _build.check("lru", lru, torch.int32, (s, w), tags.device)
    return s, w


def _launch_lookup(name: str, tags, valid, lru, lru_out, plan, n_req,
                   rounds, rec, req, hit, way) -> None:
    """Launch ``lookup_fill_kernel`` (null pointers for the arguments of
    the other mode: see the kernel)."""
    dev = tags.device
    s, w = tags.shape
    if w > MAX_WAYS:
        raise ValueError(f"{name}: {w} ways, the kernel takes at most "
                         f"{MAX_WAYS}")
    # 4 ways a lane as one uint4 of tags and LRU and one word of valid bytes
    vec = w % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (tags, lru, lru_out)) \
        and valid.data_ptr() % 4 == 0
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().lookup_fill_launch(
            ptr(tags), ptr(valid), ptr(lru), ptr(lru_out), s, w, ptr(plan),
            n_req, rounds, ptr(rec), ptr(req), ptr(hit), ptr(way), int(vec),
            _build.stream(dev))
    _build.raise_on(err, name)
    launches[name] += 1


@_charged("tag_lookup")
def tag_lookup(tags: torch.Tensor, valid: torch.Tensor, lru: torch.Tensor,
               req: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tags/valid/lru (S, W), req (S,) -> (hit (S,) int32, way (S,) int32,
    new_lru (S, W) int32): one round, no fill, a new LRU array."""
    s, w = _check_store("tag_lookup", tags, valid, lru)
    dev = tags.device
    _build.check("req", req, torch.int32, (s,), dev)
    if dev.type == "cpu":
        return tag_lookup_plain(tags, valid, lru, req)
    _build.require_cuda(dev, "tag_lookup")
    hit = torch.empty((s,), dtype=torch.int32, device=dev)
    way = torch.empty((s,), dtype=torch.int32, device=dev)
    new_lru = torch.empty((s, w), dtype=torch.int32, device=dev)
    if s == 0:                      # nothing to look up: no launch
        return hit, way, new_lru
    _launch_lookup("tag_lookup", tags, valid, lru, new_lru, None, 0, 1, None,
                   req, hit, way)
    return hit, way, new_lru


def _ranks(sets: np.ndarray) -> np.ndarray:
    """Each request's place among its set's requests, in batch order."""
    order = np.argsort(sets, kind="stable")
    s = sets[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    lengths = np.diff(np.r_[starts, len(s)])
    rank = np.empty(len(s), np.int64)
    rank[order] = np.arange(len(s)) - np.repeat(starts, lengths)
    return rank


def lookup_fill_plain(tags: torch.Tensor, valid: torch.Tensor,
                      lru: torch.Tensor, sets: np.ndarray, req: np.ndarray
                      ) -> torch.Tensor:
    """Plain PyTorch version of ``lookup_fill`` (same arguments): the
    reference's round loop, a ``tag_lookup`` over the whole store and the
    fills of its misses a round."""
    plain_runs["lookup_fill"] += 1
    dev = tags.device
    sets = np.asarray(sets, np.int64)
    req = np.ascontiguousarray(req, np.uint32).view(np.int32)
    rank = _ranks(sets)
    rec = torch.zeros((len(REC_FIELDS), len(sets)), dtype=torch.int32,
                      device=dev)
    rec[0] = -1
    n_rounds = min(ROUNDS, int(rank.max()) + 1) if len(sets) else 0
    for r in range(n_rounds):
        sel = np.flatnonzero(rank == r)
        k = torch.from_numpy(sel).to(dev)
        s = torch.from_numpy(sets[sel]).to(dev)
        q = torch.from_numpy(req[sel]).to(dev)
        full = torch.zeros(tags.shape[0], dtype=torch.int32, device=dev)
        full[s] = q
        hit, way, new_lru = _lookup(tags, valid, lru, full)
        lru.copy_(new_lru)
        h = hit[s].bool()
        rec[0, k] = r
        rec[1, k] = h.to(torch.int32)
        rec[2, k] = torch.where(h, way[s], 0)
        # each miss fills its set's LRU victim: the least counter, invalid
        # ways (as -1) first, the lowest way on ties
        ms, mk = s[~h], k[~h]
        vw = torch.where(valid[ms], _u32.to_u(lru[ms]), -1).argmin(dim=1)
        rec[2, mk] = vw.to(torch.int32)
        rec[3, mk] = valid[ms, vw].to(torch.int32)
        rec[4, mk] = tags[ms, vw]
        tags[ms, vw] = q[~h]
        valid[ms, vw] = True
        lru[ms, vw] = LRU_MAX
    return rec


def fill_plan(sets: np.ndarray, req: np.ndarray, n_sets: int
              ) -> Tuple[np.ndarray, int]:
    """(plan, rounds run) of ``lookup_fill_kernel``: one int32 array of the
    requests ordered by set, stably (each set's requests keep their batch
    order), as a CSR offset per set (n_sets + 1), the ordered tags (K,
    uint32 bit patterns) and each one's place in the batch (K), and
    min(ROUNDS, the longest run)."""
    order = np.argsort(sets, kind="stable")
    counts = np.bincount(sets, minlength=n_sets)
    plan = np.concatenate([np.r_[0, np.cumsum(counts)],
                           req[order].view(np.int32), order]).astype(np.int32)
    return plan, min(ROUNDS, int(counts.max()))


@_charged("lookup_fill")
def lookup_fill(tags: torch.Tensor, valid: torch.Tensor, lru: torch.Tensor,
                sets, req) -> torch.Tensor:
    """The pool's conventional tier for one batch, in place on the (S, W)
    store ``tags``/``valid``/``lru``: requests (``sets[k]``, ``req[k]``),
    host arrays in batch order, served as the reference serves them.
    Round r (r < min(ROUNDS, the longest run)) looks up each set's r-th
    request, and tag 0 in every other set, with ``tag_lookup``'s LRU
    update; a request that misses fills its set's LRU victim (tag, valid,
    LRU_MAX).  Requests past the rounds are not run.  Returns the records
    (len(REC_FIELDS), K) int32 on the store's device: the round (-1: not
    run), hit, the hit or filled way, whether the victim was valid, and
    the tag the fill replaced (0 on a hit)."""
    s, w = _check_store("lookup_fill", tags, valid, lru)
    dev = tags.device
    sets = np.asarray(sets, np.int64)
    req = np.asarray(req, np.uint32)
    if sets.ndim != 1 or req.shape != sets.shape:
        raise ValueError(f"sets and req must be (K,), got {sets.shape} and "
                         f"{req.shape}")
    if sets.size and (sets.min() < 0 or sets.max() >= s):
        raise ValueError(f"sets: outside [0, {s})")
    if dev.type == "cpu":
        return lookup_fill_plain(tags, valid, lru, sets, req)
    _build.require_cuda(dev, "lookup_fill")
    rec = torch.empty((len(REC_FIELDS), len(sets)), dtype=torch.int32,
                      device=dev)
    if not sets.size:               # nothing to look up: no launch
        return rec
    plan, n_rounds = fill_plan(sets, req, s)
    plan = torch.from_numpy(plan).to(dev)           # one copy to the card
    _launch_lookup("lookup_fill", tags, valid, lru, lru, plan, len(sets),
                   n_rounds, rec, None, None, None)
    return rec


# ------------------------------------------------------------ Bloom query

def bloom_query_plain(filters: torch.Tensor, tags: torch.Tensor,
                      rows: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``bloom_query`` (same arguments)."""
    plain_runs["bloom_query"] += 1
    words = filters.shape[1]
    if rows is not None:
        n = filters.shape[0]
        ok = (rows >= 0) & (rows < n)
        filters = torch.where(ok[:, None],
                              filters[rows.long().clamp(0, n - 1)], 0)
    bits = bloom._hash_bits(tags, words * 32)
    pred = bloom._test(filters, bits).to(torch.int32)
    return pred, bloom._bit_mask(bits, words)


@_charged("bloom_query")
def bloom_query(filters: torch.Tensor, tags: torch.Tensor,
                rows: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """filters (Q, words), tags (Q,) -> (pred (Q,) int32, insert masks
    (Q, words) int32).  With ``rows`` (Q,) int32, ``filters`` is the whole
    (S, words) store and query ``q`` tests its row ``rows[q]``."""
    if filters.dim() != 2 or filters.shape[1] < 1 or (
            rows is not None and filters.shape[0] < 1):
        raise ValueError(f"filters must be (Q, words), or (S, words) with "
                         f"S >= 1 given rows, with words >= 1, got "
                         f"{tuple(filters.shape)}")
    n, words = filters.shape
    dev = filters.device
    q = n if rows is None else tags.shape[0]
    _build.check("filters", filters, torch.int32, (n, words), dev)
    _build.check("tags", tags, torch.int32, (q,), dev)
    if rows is not None:
        _build.check("rows", rows, torch.int32, (q,), dev)
    if dev.type == "cpu":
        return bloom_query_plain(filters, tags, rows)
    _build.require_cuda(dev, "bloom_query")
    pred = torch.empty((q,), dtype=torch.int32, device=dev)
    masks = torch.empty((q, words), dtype=torch.int32, device=dev)
    if q == 0:                      # nothing to query: no launch
        return pred, masks
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().bloom_query_launch(ptr(filters), n, ptr(rows),
                                        ptr(tags), q, words, ptr(pred),
                                        ptr(masks), _build.stream(dev))
    _build.raise_on(err, "bloom_query")
    launches["bloom_query"] += 1
    return pred, masks


# ----------------------------------------------------------- Bloom record

def bloom_record_plain(bf1: torch.Tensor, bf2: torch.Tensor,
                       n_mru: torch.Tensor, sets: np.ndarray,
                       tags: np.ndarray, ways: int) -> None:
    """Plain PyTorch version of ``bloom_record`` (same arguments): the
    reference's per-key record, key by key in batch order."""
    plain_runs["bloom_record"] += 1
    words = bf1.shape[1]
    t = torch.from_numpy(np.ascontiguousarray(tags, np.uint32).view(np.int32))
    masks = bloom._bit_mask(bloom._hash_bits(t.to(bf1.device), words * 32),
                            words)
    for s, m in zip(np.asarray(sets).tolist(), masks):
        in_bf2 = ((bf2[s] & m) == m).all()
        bf1[s] |= m
        bf2[s] |= m
        n_mru[s] += (~in_bf2).to(torch.int32)
        swap = n_mru[s] >= ways             # swap (paper Fig. 6 (9))
        bf1[s] = torch.where(swap, bf2[s], bf1[s])
        bf2[s] = torch.where(swap, 0, bf2[s])
        n_mru[s] = torch.where(swap, 0, n_mru[s])


def record_plan(sets: np.ndarray, tags: np.ndarray) -> Tuple[np.ndarray, int]:
    """(plan, runs) of ``bloom_record_kernel``: the keys ordered by set,
    stably (each set's keys keep their batch order), as one int32 array
    of the runs' sets (runs), their offsets into the ordered tags (runs +
    1) and those tags (K, uint32 bit patterns)."""
    order = np.argsort(sets, kind="stable")
    s = sets[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    plan = np.concatenate([s[starts], starts, [len(s)],
                           tags[order].view(np.int32)]).astype(np.int32)
    return plan, len(starts)


@_charged("bloom_record")
def bloom_record(bf1: torch.Tensor, bf2: torch.Tensor, n_mru: torch.Tensor,
                 sets, tags, ways: int) -> None:
    """In place: record the keys (``sets[k]``, ``tags[k]``) in order into
    the (S, words) filters ``bf1``/``bf2`` and the (S,) int32 MRU counts
    ``n_mru``; ``sets`` and ``tags`` are host arrays (the wrapper plans the
    launch on the host), ``ways`` the count that triggers a swap."""
    if bf1.dim() != 2 or bf1.shape[1] < 1:
        raise ValueError(f"bf1 must be (S, words) with words >= 1, got "
                         f"{tuple(bf1.shape)}")
    (n, words), dev = bf1.shape, bf1.device
    _build.check("bf1", bf1, torch.int32, (n, words), dev)
    _build.check("bf2", bf2, torch.int32, (n, words), dev)
    _build.check("n_mru", n_mru, torch.int32, (n,), dev)
    sets = np.asarray(sets, np.int64)
    tags = np.asarray(tags, np.uint32)
    if sets.ndim != 1 or tags.shape != sets.shape:
        raise ValueError(f"sets and tags must be (K,), got {sets.shape} and "
                         f"{tags.shape}")
    if sets.size and (sets.min() < 0 or sets.max() >= n):
        raise ValueError(f"sets: outside [0, {n})")
    if dev.type == "cpu":
        bloom_record_plain(bf1, bf2, n_mru, sets, tags, ways)
        return
    _build.require_cuda(dev, "bloom_record")
    if words > MAX_RECORD_WORDS:
        raise ValueError(f"bloom_record: {words} filter words, the kernel "
                         f"takes at most {MAX_RECORD_WORDS}")
    if not sets.size:               # nothing to record: no launch
        return
    plan, runs = record_plan(sets, tags)
    plan = torch.from_numpy(plan).to(dev)           # one copy to the card
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().bloom_record_launch(ptr(bf1), ptr(bf2), ptr(n_mru),
                                         ptr(plan), runs, words, int(ways),
                                         _build.stream(dev))
    _build.raise_on(err, "bloom_record")
    launches["bloom_record"] += 1


# ------------------------------------------------------ BDI, page write

def _compress(blocks: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = _u32.to_u(blocks)
    d = (x - x[:, :1]) & _u32.MASK
    fits8 = ((d <= 127) | (d >= (1 << 32) - 128)).all(dim=1)
    fits16 = ((d <= 32767) | (d >= (1 << 32) - 32768)).all(dim=1)
    level = torch.where(fits8, HIGH, torch.where(fits16, LOW, UNCOMP)
                        ).to(torch.int32)
    payload = torch.where((level == UNCOMP)[:, None], blocks, _u32.to_i32(d))
    return level, blocks[:, 0].clone(), payload


def bdi_compress_plain(blocks: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``bdi_compress`` (same arguments)."""
    plain_runs["bdi_compress"] += 1
    return _compress(blocks)


@_charged("bdi_compress")
def bdi_compress(blocks: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """blocks (N, 32) -> (level (N,) int32, base (N,), payload (N, 32))."""
    if blocks.dim() != 2 or blocks.shape[1] != SEGMENTS:
        raise ValueError(f"blocks must be (N, {SEGMENTS}), got "
                         f"{tuple(blocks.shape)}")
    n = blocks.shape[0]
    dev = blocks.device
    _build.check("blocks", blocks, torch.int32, (n, SEGMENTS), dev)
    if dev.type == "cpu":
        return bdi_compress_plain(blocks)
    _build.require_cuda(dev, "bdi_compress")
    level = torch.empty((n,), dtype=torch.int32, device=dev)
    base = torch.empty((n,), dtype=torch.int32, device=dev)
    payload = torch.empty((n, SEGMENTS), dtype=torch.int32, device=dev)
    if n == 0:                      # nothing to compress: no launch
        return level, base, payload
    _launch_write("bdi_compress", None, None, payload, level, base, None,
                  blocks, n)
    return level, base, payload


def _pages(pages, n: int, words: int, dev: torch.device):
    """``page_write``'s pages: a host (N, words) uint32 array, or an int32
    tensor on the store's device, checked."""
    if isinstance(pages, torch.Tensor):
        _build.check("pages", pages, torch.int32, (n, words), dev)
        return pages
    pages = np.ascontiguousarray(pages, np.uint32)
    if pages.shape != (n, words):
        raise ValueError(f"pages: shape {pages.shape}, expected "
                         f"{(n, words)}")
    return pages


def page_write_plain(tags: torch.Tensor, valid: torch.Tensor,
                     data: torch.Tensor, level: Optional[torch.Tensor],
                     base: Optional[torch.Tensor], sets: np.ndarray,
                     page_tags: np.ndarray, pages) -> None:
    """Plain PyTorch version of ``page_write`` (same arguments): the
    reference's probe, then the compression and the writes, page by
    page."""
    plain_runs["page_write"] += 1
    if isinstance(pages, np.ndarray):
        pages = torch.from_numpy(pages.view(np.int32)).to(data.device)
    for i, (s, t) in enumerate(zip(np.asarray(sets).tolist(),
                                   np.asarray(page_tags, np.uint32).view(
                                       np.int32).tolist())):
        m = valid[s] & (tags[s] == t)
        if not bool(m.any()):
            continue                # a miss writes nothing
        w = int(m.to(torch.int32).argmax())         # the first way
        if level is None:
            data[s, w] = pages[i]
            continue
        lv, b, pay = _compress(pages[i:i + 1])
        level[s, w], base[s, w], data[s, w] = lv[0], b[0], pay[0]


@_charged("page_write")
def page_write(tags: torch.Tensor, valid: torch.Tensor, data: torch.Tensor,
               level: Optional[torch.Tensor], base: Optional[torch.Tensor],
               sets, page_tags, pages) -> None:
    """In place: the pool's ``write_page`` for N pages.  Page n goes to row
    (``sets[n]``, w) of the (S, W, words) store ``data``, where w is the
    first valid way of that set whose tag in the (S, W) ``tags``/``valid``
    is ``page_tags[n]``; a page no way holds is not written.  With
    ``level`` and ``base`` ((S, W) int32) the page is BDI-compressed
    (words = 32) and its level and base written beside it.  ``sets`` and
    ``page_tags`` are host arrays (N,) with no (set, tag) twice;
    ``pages`` a host (N, words) uint32 array or an int32 tensor on the
    store's device."""
    s, w = _check_store("page_write", tags, valid)
    dev = tags.device
    if data.dim() != 3:
        raise ValueError(f"data must be (S, W, words), got "
                         f"{tuple(data.shape)}")
    words = data.shape[2]
    _build.check("data", data, torch.int32, (s, w, words), dev)
    if (level is None) != (base is None):
        raise ValueError("level and base: give both or neither")
    if level is not None:
        _build.check("level", level, torch.int32, (s, w), dev)
        _build.check("base", base, torch.int32, (s, w), dev)
        if words != SEGMENTS:
            raise ValueError(f"data: BDI compresses pages of {SEGMENTS} "
                             f"words, got {words}")
    sets = np.asarray(sets, np.int64)
    page_tags = np.asarray(page_tags, np.uint32)
    if sets.ndim != 1 or page_tags.shape != sets.shape:
        raise ValueError(f"sets and page_tags must be (N,), got "
                         f"{sets.shape} and {page_tags.shape}")
    if sets.size and (sets.min() < 0 or sets.max() >= s):
        raise ValueError(f"sets: outside [0, {s})")
    pairs = sets << 32 | page_tags.astype(np.int64)
    if len(np.unique(pairs)) != len(pairs):
        raise ValueError("page_write: a (set, tag) key is repeated; the "
                         "pages would race for one row")
    pages = _pages(pages, len(sets), words, dev)
    if dev.type == "cpu":
        page_write_plain(tags, valid, data, level, base, sets, page_tags,
                         pages)
        return
    _build.require_cuda(dev, "page_write")
    if not sets.size:               # nothing to write: no launch
        return
    keys = np.concatenate([sets, page_tags.view(np.int32)])
    if isinstance(pages, np.ndarray):       # keys and pages: one copy
        keys = np.concatenate([keys, pages.ravel().view(np.int32)])
    buf = torch.from_numpy(keys.astype(np.int32)).to(dev)
    if isinstance(pages, np.ndarray):
        pages = buf[2 * len(sets):]
    _launch_write("page_write", tags, valid, data, level, base, buf[:2 * len(
        sets)], pages, len(sets))


def _launch_write(name: str, tags, valid, data, level, base, keys, pages,
                  n: int) -> None:
    """Launch ``page_write_kernel`` on ``n`` pages (without ``tags``, page
    p into row p of ``data``)."""
    s, w = tags.shape if tags is not None else (0, 0)
    ptr = _build.ptr
    with torch.cuda.device(data.device):
        err = _lib().page_write_launch(
            ptr(tags), ptr(valid), s, w, ptr(data), ptr(level), ptr(base),
            data.shape[-1], ptr(keys), ptr(pages), n,
            _build.stream(data.device))
    _build.raise_on(err, name)
    launches[name] += 1


def _restore(level, base, payload) -> torch.Tensor:
    restored = _u32.to_i32(_u32.to_u(base)[:, None] + _u32.to_u(payload))
    return torch.where((level == UNCOMP)[:, None], payload, restored)


def bdi_decompress_plain(level: torch.Tensor, base: torch.Tensor,
                         payload: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``bdi_decompress`` (same arguments)."""
    plain_runs["bdi_decompress"] += 1
    return _restore(level, base, payload)


@_charged("bdi_decompress")
def bdi_decompress(level: torch.Tensor, base: torch.Tensor,
                   payload: torch.Tensor) -> torch.Tensor:
    """level (N,) int32, base (N,), payload (N, words) -> (N, words)."""
    if payload.dim() != 2:
        raise ValueError(f"payload must be (N, words), got "
                         f"{tuple(payload.shape)}")
    return _read("bdi_decompress", payload.unsqueeze(1), None, level, base)


# ------------------------------------------------------------ block read

def _gather(data: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    s, w, _ = data.shape
    way = way.to(torch.int64)
    ok = (way >= 0) & (way < w)
    rows = data[torch.arange(s, device=data.device), way.clamp(0, w - 1)]
    return torch.where(ok[:, None], rows, 0)


def gather_blocks_plain(data: torch.Tensor, way: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of ``gather_blocks`` (same arguments)."""
    plain_runs["gather_blocks"] += 1
    return _gather(data, way)


def cached_block_read_plain(data, way, level, base) -> torch.Tensor:
    """Plain PyTorch version of ``cached_block_read`` (same arguments)."""
    plain_runs["cached_block_read"] += 1
    return _restore(level, base, _gather(data, way))


@_charged("gather_blocks")
def gather_blocks(data: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    """data (S, W, words), way (S,) -> (S, words): row ``way[s]`` of each
    set."""
    return _read("gather_blocks", data, way, None, None)


@_charged("cached_block_read")
def cached_block_read(data: torch.Tensor, way: torch.Tensor,
                      level: torch.Tensor, base: torch.Tensor
                      ) -> torch.Tensor:
    """Extended-tier read: ``bdi_decompress(level, base,
    gather_blocks(data, way))`` in one pass of one kernel."""
    return _read("cached_block_read", data, way, level, base)


def read_rows_plain(conv, ext, ext_level, ext_base, tier, set_idx, way
                    ) -> torch.Tensor:
    """Plain PyTorch version of ``read_rows`` (same arguments)."""
    plain_runs["read_rows"] += 1
    out = torch.zeros((tier.shape[0], conv.shape[2]), dtype=torch.int32,
                      device=conv.device)
    for t, store in enumerate((conv, ext)):
        n_sets, n_ways = store.shape[:2]
        ok = ((tier == t) & (set_idx >= 0) & (set_idx < n_sets) & (way >= 0)
              & (way < n_ways))
        s = set_idx.long().clamp(0, n_sets - 1)
        w = way.long().clamp(0, n_ways - 1)
        rows = store[s, w]
        if t == 1:
            rows = _restore(ext_level[s, w], ext_base[s, w], rows)
        out = torch.where(ok[:, None], rows, out)
    return out


@_charged("read_rows")
def read_rows(conv: torch.Tensor, ext: torch.Tensor, ext_level: torch.Tensor,
              ext_base: torch.Tensor, tier: torch.Tensor,
              set_idx: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    """The pool's block read over both tiers: conv (Sc, Wc, words), ext
    (Se, We, words) with ext_level and ext_base (Se, We), and tier,
    set_idx, way (N,) int32 -> (N, words): ``conv[set, way]`` on tier 0,
    ``ext[set, way]`` restored on tier 1, zeros on tier 2 or out of the
    store."""
    for name, t in (("conv", conv), ("ext", ext)):
        if t.dim() != 3 or t.shape[0] < 1 or t.shape[1] < 1:
            raise ValueError(f"{name} must be (S, W, words) with S, W >= 1, "
                             f"got {tuple(t.shape)}")
    (sc, wc, words), (se, we, _), dev = conv.shape, ext.shape, conv.device
    n = tier.shape[0] if tier.dim() == 1 else -1
    _build.check("conv", conv, torch.int32, (sc, wc, words), dev)
    _build.check("ext", ext, torch.int32, (se, we, words), dev)
    _build.check("ext_level", ext_level, torch.int32, (se, we), dev)
    _build.check("ext_base", ext_base, torch.int32, (se, we), dev)
    for name, t in (("tier", tier), ("set_idx", set_idx), ("way", way)):
        _build.check(name, t, torch.int32, (n,), dev)
    if dev.type == "cpu":
        return read_rows_plain(conv, ext, ext_level, ext_base, tier,
                               set_idx, way)
    _build.require_cuda(dev, "read_rows")
    return _launch_read("read_rows", n, words, dev, conv=conv, ext=ext,
                        level=ext_level, base=ext_base, tier=tier,
                        set_idx=set_idx, way=way)


_PLAIN_READS = {
    "gather_blocks": lambda d, w, l, b: gather_blocks_plain(d, w),
    "cached_block_read": cached_block_read_plain,
    "bdi_decompress": lambda d, w, l, b: bdi_decompress_plain(l, b, d[:, 0]),
}


def _read(name: str, data: torch.Tensor, way: Optional[torch.Tensor],
          level: Optional[torch.Tensor], base: Optional[torch.Tensor]
          ) -> torch.Tensor:
    """The three reference-signature block reads: check data (S, W, words)
    int32 and, where given, (S,) int32 way, level and base on data's
    device; run the plain version on the CPU, else launch
    ``block_read_kernel`` with row r reading set r (tier 0 without a
    level, tier 1 restored with the row's level and base)."""
    if data.dim() != 3 or data.shape[1] < 1:
        raise ValueError(f"data must be (S, W, words) with W >= 1, got "
                         f"{tuple(data.shape)}")
    (s, w, words), dev = data.shape, data.device
    _build.check("data", data, torch.int32, (s, w, words), dev)
    if way is not None:
        _build.check("way", way, torch.int32, (s,), dev)
    if level is not None:
        _build.check("level", level, torch.int32, (s,), dev)
        _build.check("base", base, torch.int32, (s,), dev)
    if dev.type == "cpu":
        return _PLAIN_READS[name](data, way, level, base)
    _build.require_cuda(dev, name)
    if level is None:
        return _launch_read(name, s, words, dev, conv=data, way=way)
    return _launch_read(name, s, words, dev, ext=data, level=level,
                        base=base, level_per_row=True, fixed_tier=1, way=way)


def _launch_read(name: str, n: int, words: int, dev: torch.device, *,
                 conv=None, ext=None, level=None, base=None,
                 level_per_row=False, tier=None, fixed_tier=0, set_idx=None,
                 way=None) -> torch.Tensor:
    """Launch ``block_read_kernel`` for ``n`` output rows (null pointers
    for the arguments not given: see the kernel)."""
    out = torch.empty((n, words), dtype=torch.int32, device=dev)
    if n == 0 or words == 0:        # nothing to read: no launch
        return out
    sc, wc = conv.shape[:2] if conv is not None else (0, 0)
    se, we = ext.shape[:2] if ext is not None else (0, 0)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().block_read_launch(
            ptr(conv), sc, wc, ptr(ext), se, we, ptr(level), ptr(base),
            int(level_per_row), ptr(tier), fixed_tier, ptr(set_idx),
            ptr(way), n, words, ptr(out), _build.stream(dev))
    _build.raise_on(err, name)
    launches[name] += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/pool.cu`` with its five launchers declared."""
    lib = _build.load("pool")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args in (("lookup_fill_launch", [p] * 4 + [n, i, p, i, i]
                      + [p] * 4 + [i, p]),
                     ("bloom_query_launch", [p, n, p, p, n, i, p, p, p]),
                     ("bloom_record_launch", [p] * 4 + [i, i, i, p]),
                     ("page_write_launch", [p, p, n, i, p, p, p, i, p, p, n,
                                            p]),
                     ("block_read_launch", [p, n, i, p, n, i, p, p, i, p, i,
                                            p, p, n, i, p, p])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i
    return lib
