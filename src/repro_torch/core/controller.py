"""The Morpheus controller (paper §4.1) as per-set transition functions,
after ``repro.core.controller``.

All mutable simulator state is keyed by (tier, set), and every request
touches exactly one set, so the simulation decomposes into independent
per-set state machines.  ``conv_set_kernel`` and ``ext_set_kernel`` map
(one set's state rows, one request) to (new rows, outcome); they
broadcast over any leading dimensions, so the same code steps one set
(the serial oracle ``step``/``simulate``) or every (trace, set) of a
packed batch at once (the plain version of ``kernels.engine_scan``).
``request_stats`` turns an outcome into the per-request Stats delta.

Row leaves are tensors with the ways on the last dimension; tags and LRU
counters are int32 tensors holding the uint32 bit pattern (see the
package docstring).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _u32
from . import address_separation as asep
from . import bloom as bloomlib
from .compression import BLOCK_BYTES, HIGH, LOW
from .energy import PaperGPU
from .tag_store import LRU_MAX


class Predictor(enum.Enum):
    BLOOM = "bloom"       # paper design (§4.1.2)
    NONE = "none"         # ablation: forward everything (Fig. 13 No-Prediction)
    PERFECT = "perfect"   # ablation: oracle (Fig. 13 Perfect-Prediction)


@dataclass(frozen=True)
class MorpheusConfig:
    amap: asep.AddressMap
    conv_ways: int = 32
    ext_ways: int = 32              # logical ways at 128 B (budget = ways*128)
    compression: bool = False
    predictor: Predictor = Predictor.BLOOM
    indirect_mov: bool = False      # §4.3.2 ISA support: faster data access
    costs: PaperGPU = PaperGPU()

    @property
    def ext_enabled(self) -> bool:
        return self.amap.ext_sets > 0

    @property
    def ext_max_ways(self) -> int:
        return self.ext_ways * (BLOCK_BYTES // 32) if self.compression \
            else self.ext_ways

    @property
    def ext_budget_bytes(self) -> int:
        return self.ext_ways * BLOCK_BYTES

    def latencies(self) -> Tuple[float, float, float, float, float]:
        """(conv_hit, conv_miss, ext_hit, ext_miss, pred_miss) in ns."""
        c = self.costs
        ext_hit = c.ext_llc.hit_latency_ns
        ext_miss = c.ext_llc.miss_latency_ns
        if self.indirect_mov:
            # §4.3.2: native Indirect-MOV removes the brx.idx switch from
            # every data-array access.
            ext_hit -= 40.0
            ext_miss -= 40.0
        if self.compression:
            ext_hit += 10.0  # BDI decompress on the hit path (§4.3.1)
        return (c.conv_llc.hit_latency_ns, c.conv_llc.miss_latency_ns,
                ext_hit, ext_miss, c.predicted_miss_latency_ns)


class Stats(NamedTuple):
    conv_hits: torch.Tensor       # int32 counters
    conv_misses: torch.Tensor
    ext_hits: torch.Tensor
    ext_false_pos: torch.Tensor   # forwarded but actually a miss
    ext_pred_miss: torch.Tensor   # predicted miss, went straight to DRAM
    ext_true_miss: torch.Tensor
    dram_accesses: torch.Tensor
    writebacks: torch.Tensor
    latency_ns: torch.Tensor      # float32 sums
    energy_nJ: torch.Tensor
    noc_bytes: torch.Tensor       # extended-tier interconnect traffic (§7.4)
    conv_bytes: torch.Tensor
    dram_bytes: torch.Tensor
    bloom_swaps: torch.Tensor     # int32


_INT_FIELDS = ("conv_hits", "conv_misses", "ext_hits", "ext_false_pos",
               "ext_pred_miss", "ext_true_miss", "dram_accesses",
               "writebacks", "bloom_swaps")


def zero_stats(shape: Tuple[int, ...] = (), device=None) -> Stats:
    """Stats of zeros with leaves of ``shape``."""
    return Stats(**{
        f: torch.zeros(shape, dtype=torch.int32 if f in _INT_FIELDS
                       else torch.float32, device=device)
        for f in Stats._fields})


# 32-byte Bloom filters (paper §4.1.2 'Cost')
BLOOM_WORDS = 8


class ConvRow(NamedTuple):
    """Conventional-LLC set rows: (..., ways) metadata."""
    tags: torch.Tensor     # int32 (uint32 pattern)
    valid: torch.Tensor    # bool
    dirty: torch.Tensor    # bool
    lru: torch.Tensor      # int32 (uint32 pattern)


class ExtRow(NamedTuple):
    """Extended-LLC set rows: (..., ext_max_ways) metadata + predictor."""
    tags: torch.Tensor
    valid: torch.Tensor
    dirty: torch.Tensor
    lru: torch.Tensor
    size: torch.Tensor     # int32 physical bytes per block
    used: torch.Tensor     # (...) int32
    bf1: torch.Tensor      # (..., words) int32 (uint32 pattern)
    bf2: torch.Tensor
    n_mru: torch.Tensor    # (...) int32


class ConvOutcome(NamedTuple):
    hit: torch.Tensor       # bool
    evict_wb: torch.Tensor  # bool: the miss evicted a dirty block


class ExtOutcome(NamedTuple):
    hit: torch.Tensor       # bool
    pred: torch.Tensor      # bool: the predictor said "forward"
    wbs: torch.Tensor       # int32: dirty blocks written back on insert
    swap: torch.Tensor      # bool: the Bloom filters swapped this access


def conv_row_zero(cfg: MorpheusConfig, shape: Tuple[int, ...] = (),
                  device=None) -> ConvRow:
    w = shape + (cfg.conv_ways,)
    return ConvRow(torch.zeros(w, dtype=torch.int32, device=device),
                   torch.zeros(w, dtype=torch.bool, device=device),
                   torch.zeros(w, dtype=torch.bool, device=device),
                   torch.zeros(w, dtype=torch.int32, device=device))


def ext_row_zero(cfg: MorpheusConfig, shape: Tuple[int, ...] = (),
                 device=None) -> ExtRow:
    w = shape + (cfg.ext_max_ways,)
    words = shape + (BLOOM_WORDS,)
    i32 = dict(dtype=torch.int32, device=device)
    return ExtRow(torch.zeros(w, **i32),
                  torch.zeros(w, dtype=torch.bool, device=device),
                  torch.zeros(w, dtype=torch.bool, device=device),
                  torch.zeros(w, **i32), torch.zeros(w, **i32),
                  torch.zeros(shape, **i32),
                  torch.zeros(words, **i32), torch.zeros(words, **i32),
                  torch.zeros(shape, **i32))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a bool (..., W) mask: the first True index, or 0
    when there is none."""
    idx = torch.arange(mask.shape[-1], device=mask.device)
    first = torch.where(mask, idx, mask.shape[-1]).min(dim=-1).values
    return torch.where(mask.any(dim=-1), first, 0)


def _first_argmin(key: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin`` over the last dimension: the lowest index among the
    least keys (keys are small non-negative or -1)."""
    w = key.shape[-1]
    idx = torch.arange(w, device=key.device)
    comp = key.to(torch.int64) * w + idx
    return torch.remainder(comp.min(dim=-1).values, w)


def _pick(a: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    """``a[..., way]`` for a per-row way index."""
    return torch.gather(a, -1, way.unsqueeze(-1)).squeeze(-1)


def conv_set_kernel(cfg: MorpheusConfig, row: ConvRow, tag: torch.Tensor,
                    is_write: torch.Tensor) -> Tuple[ConvRow, ConvOutcome]:
    """LRU lookup/insert on conventional sets (Algorithm-1 metadata)."""
    ctags, cvalid, cdirty, clru = row
    tag = tag.unsqueeze(-1)
    wr = is_write.unsqueeze(-1)
    cmatch = cvalid & (ctags == tag)
    c_hit = cmatch.any(dim=-1)
    way_hit = _first_true(cmatch)
    vkey = torch.where(cvalid, clru.to(torch.int64), -1)
    way_vic = _first_argmin(vkey)
    way = torch.where(c_hit, way_hit, way_vic)
    idx = torch.arange(ctags.shape[-1], device=ctags.device)
    onehot = idx == way.unsqueeze(-1)
    c_evict_wb = ~c_hit & _pick(cvalid, way_vic) & _pick(cdirty, way_vic)
    ins = onehot & ~c_hit.unsqueeze(-1)
    n_ctags = torch.where(ins, tag, ctags)
    n_cvalid = cvalid | ins
    n_cdirty = torch.where(onehot, torch.where(c_hit.unsqueeze(-1),
                                               cdirty | wr, wr), cdirty)
    n_clru = torch.where(onehot, LRU_MAX, _u32.sat_dec(clru))
    return (ConvRow(n_ctags, n_cvalid, n_cdirty, n_clru),
            ConvOutcome(c_hit, c_evict_wb))


def ext_set_kernel(cfg: MorpheusConfig, row: ExtRow, tag: torch.Tensor,
                   is_write: torch.Tensor, level: torch.Tensor
                   ) -> Tuple[ExtRow, ExtOutcome]:
    """Predict -> lookup -> touch/insert on extended sets (§4.1-§4.3)."""
    etags, evalid, edirty, elru = row.tags, row.valid, row.dirty, row.lru
    esize, eused = row.size, row.used
    bf1, bf2, n = row.bf1, row.bf2, row.n_mru
    dev = etags.device
    tag_c = tag.unsqueeze(-1)
    wr = is_write.unsqueeze(-1)

    ematch = evalid & (etags == tag_c)
    e_hit = ematch.any(dim=-1)
    e_way = _first_true(ematch)

    words = bf1.shape[-1]
    bits = bloomlib._hash_bits(tag, words * 32)
    if cfg.predictor is Predictor.BLOOM:
        pred = bloomlib._test(bf1, bits)
    elif cfg.predictor is Predictor.PERFECT:
        pred = e_hit
    else:
        pred = torch.ones_like(e_hit)

    if cfg.compression:
        phys = torch.where(level == HIGH, 32,
                           torch.where(level == LOW, 64, BLOCK_BYTES))
    else:
        phys = torch.full_like(level, BLOCK_BYTES)
    phys = phys.to(torch.int32)

    # touch path (hit): Algorithm 1 lines 8-12
    eidx = torch.arange(etags.shape[-1], device=dev)
    dec = _u32.sat_dec(elru)
    t_onehot = eidx == e_way.unsqueeze(-1)
    t_lru = torch.where(t_onehot, LRU_MAX, dec)
    t_dirty = edirty | (t_onehot & wr)

    # insert path (miss): LRU-evict until the block fits (<= 4 evictions)
    i_valid, i_dirty, i_size, i_used = evalid, edirty, esize, eused
    wbs = torch.zeros_like(eused)
    budget = cfg.ext_budget_bytes
    key_lru = elru.to(torch.int64)
    for _ in range(BLOCK_BYTES // 32):
        need = (i_used + phys) > budget
        key = torch.where(i_valid, key_lru, LRU_MAX + 1)
        v = _first_argmin(key)
        can = need & i_valid.any(dim=-1)
        oh = (eidx == v.unsqueeze(-1)) & can.unsqueeze(-1)
        wbs = wbs + (can & _pick(i_dirty, v)).to(torch.int32)
        i_used = torch.where(can, i_used - _pick(i_size, v), i_used)
        i_valid = i_valid & ~oh
        i_dirty = i_dirty & ~oh
        i_size = torch.where(oh, 0, i_size)
    free_way = _first_true(~i_valid)
    oh = eidx == free_way.unsqueeze(-1)
    i_tags = torch.where(oh, tag_c, etags)
    i_valid = i_valid | oh
    i_dirty = torch.where(oh, wr, i_dirty)
    i_size = torch.where(oh, phys.unsqueeze(-1), i_size)
    i_lru = torch.where(oh, LRU_MAX, dec)
    i_used = i_used + phys

    # merge: hit -> touch rows; miss -> insert rows
    h = e_hit.unsqueeze(-1)
    n_etags = torch.where(h, etags, i_tags)
    n_evalid = torch.where(h, evalid, i_valid)
    n_edirty = torch.where(h, t_dirty, i_dirty)
    n_elru = torch.where(h, t_lru, i_lru)
    n_esize = torch.where(h, esize, i_size)
    n_eused = torch.where(e_hit, eused, i_used)

    # Bloom maintenance (Fig. 6(b)): every ext access inserts into both
    # filters; n += (tag not already in BF2); swap at n >= associativity.
    if cfg.predictor is Predictor.BLOOM:
        mask = bloomlib._bit_mask(bits, words)
        was_in_bf2 = bloomlib._test(bf2, bits)
        u_bf1, u_bf2 = bf1 | mask, bf2 | mask
        u_n = n + (~was_in_bf2).to(torch.int32)
        do_swap = u_n >= cfg.ext_ways    # logical associativity
        s = do_swap.unsqueeze(-1)
        n_bf1 = torch.where(s, u_bf2, u_bf1)
        n_bf2 = torch.where(s, 0, u_bf2)
        u_n = torch.where(do_swap, 0, u_n)
    else:
        n_bf1, n_bf2, u_n = bf1, bf2, n
        do_swap = torch.zeros_like(e_hit)

    return (ExtRow(n_etags, n_evalid, n_edirty, n_elru, n_esize, n_eused,
                   n_bf1, n_bf2, u_n),
            ExtOutcome(e_hit, pred, wbs, do_swap))


def request_stats(cfg: MorpheusConfig, sel_c: torch.Tensor,
                  conv: Optional[ConvOutcome], is_ext: torch.Tensor,
                  ext: Optional[ExtOutcome]) -> Stats:
    """Per-request Stats delta (the §7 metrics of one request).

    ``sel_c``/``is_ext`` gate the conventional/extended contributions.  A
    side whose outcome is None is held False, as the reference's
    ``_NO_CONV``/``_NO_EXT`` outcomes are.
    """
    c = cfg.costs
    lat_ch, lat_cm, lat_eh, lat_em, lat_pm = cfg.latencies()
    e_conv = BLOCK_BYTES * c.conv_llc.energy_pJ_per_B * 1e-3   # nJ
    e_ext = BLOCK_BYTES * c.ext_llc.energy_pJ_per_B * 1e-3
    e_dram = BLOCK_BYTES * c.dram.energy_pJ_per_B * 1e-3
    false = torch.zeros_like(sel_c)
    if conv is None:
        conv = ConvOutcome(false, false)
    if ext is None:
        ext = ExtOutcome(false, false, torch.zeros_like(sel_c, dtype=torch.int32),
                         false)

    i1 = lambda b: b.to(torch.int32)
    f1 = lambda b: b.to(torch.float32)
    e_hit, pred, wbs = ext.hit, ext.pred, ext.wbs
    ext_hit_e = is_ext & e_hit                       # served by ext tier
    ext_fp = is_ext & ~e_hit & pred                  # forwarded, missed
    ext_pm = is_ext & ~pred                          # straight to DRAM
    conv_hit_e = sel_c & conv.hit
    conv_miss_e = sel_c & ~conv.hit
    ext_miss = is_ext & ~e_hit
    dram = conv_miss_e | ext_miss
    wb = i1(conv_miss_e & conv.evict_wb) + torch.where(ext_miss, wbs, 0)

    lat = (f1(conv_hit_e) * lat_ch + f1(conv_miss_e) * lat_cm
           + f1(ext_hit_e) * lat_eh + f1(ext_fp) * lat_em + f1(ext_pm) * lat_pm)
    wb_f = f1(wb > 0) * wb
    energy = (f1(sel_c) * e_conv                    # conv lookup+data
              + f1(ext_hit_e | ext_fp) * e_ext      # ext lookup+data
              + f1(ext_pm) * e_ext * 0.05           # predictor-only energy
              + f1(dram) * e_dram + wb_f * e_dram)
    # Extra interconnect traffic of the extended tier: one 128 B data leg
    # per lookup that reaches a cache-mode core, one per insert payload,
    # plus dirty writebacks leaving the core.
    noc = (i1(ext_hit_e | ext_fp) + i1(ext_miss)
           + torch.where(ext_miss, wbs, 0)) * BLOCK_BYTES

    use_bloom = is_ext & (cfg.predictor is Predictor.BLOOM)
    return Stats(
        conv_hits=i1(conv_hit_e),
        conv_misses=i1(conv_miss_e),
        ext_hits=i1(ext_hit_e),
        ext_false_pos=i1(ext_fp),
        ext_pred_miss=i1(ext_pm),
        ext_true_miss=i1(ext_miss),
        dram_accesses=i1(dram),
        writebacks=i1(wb),
        latency_ns=lat,
        energy_nJ=energy,
        noc_bytes=f1(noc),
        conv_bytes=f1(sel_c) * BLOCK_BYTES,
        dram_bytes=f1(dram) * BLOCK_BYTES + wb_f * BLOCK_BYTES,
        bloom_swaps=i1(use_bloom & ext.swap),
    )


def add_stats(a: Stats, b: Stats) -> Stats:
    return Stats(*[x + y for x, y in zip(a, b)])


# ------------------------------------------------------- the serial oracle

class MorpheusState(NamedTuple):
    """Whole-cache state of one trace: (sets, ways) rows of both tiers."""
    conv: ConvRow        # leaves (conv_sets, conv_ways)
    ext: ExtRow          # leaves (ext_sets, ext_max_ways) / (ext_sets,)
    stats: Stats         # 0-d leaves


def make_state(cfg: MorpheusConfig, device=None) -> MorpheusState:
    return MorpheusState(
        conv=conv_row_zero(cfg, (max(cfg.amap.conv_sets, 1),), device),
        ext=ext_row_zero(cfg, (max(cfg.amap.ext_sets, 1),), device),
        stats=zero_stats((), device))


def step(cfg: MorpheusConfig, st: MorpheusState, addr: int, is_write: bool,
         level: int, count: bool = True) -> MorpheusState:
    """Process one LLC request: route it, apply the tier's set kernel to
    the routed set's rows (updated in place), and add its Stats delta when
    ``count``.  ``level`` is the block's BDI level."""
    dev = st.stats.latency_ns.device
    a = torch.tensor(int(addr), dtype=torch.int64, device=dev)
    tier, local = asep.route(cfg.amap, a)
    tag = _u32.to_i32(asep.tag_of(cfg.amap, a))
    is_ext = cfg.ext_enabled and int(tier) == asep.EXTENDED
    s = int(local)
    wr = torch.tensor(bool(is_write), device=dev)
    on = torch.tensor(bool(count), device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    if is_ext:
        row = ExtRow(*[x[s] for x in st.ext])
        new_row, out = ext_set_kernel(
            cfg, row, tag, wr, torch.tensor(int(level), dtype=torch.int32,
                                            device=dev))
        for dst, val in zip(st.ext, new_row):
            dst[s] = val
        delta = request_stats(cfg, off, None, on, out)
    else:
        row = ConvRow(*[x[s] for x in st.conv])
        new_row, out = conv_set_kernel(cfg, row, tag, wr)
        for dst, val in zip(st.conv, new_row):
            dst[s] = val
        delta = request_stats(cfg, on, out, off, None)
    return st._replace(stats=add_stats(st.stats, delta))


def simulate(cfg: MorpheusConfig, addrs, writes, levels, warmup: int = 0,
             device=None) -> Stats:
    """Replay a request trace one request at a time (the serial oracle).

    The first ``warmup`` accesses update cache/predictor state but are
    excluded from the returned stats.  ``device=None`` means the CUDA
    card; pass ``device="cpu"`` to run on the host."""
    from .engine import resolve_device     # engine imports this module
    dev = resolve_device(device)
    st = make_state(cfg, dev)
    addrs = np.asarray(addrs, np.uint32)
    writes = np.asarray(writes, bool)
    levels = np.asarray(levels, np.int32)
    for i in range(len(addrs)):
        st = step(cfg, st, int(addrs[i]), bool(writes[i]), int(levels[i]),
                  count=i >= warmup)
    return st.stats
