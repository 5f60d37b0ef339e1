"""Extended-LLC storage model: byte-budgeted, compression-aware sets, after
``repro.core.extended_cache``.

Models the storage the extended-LLC kernel manages inside a cache-mode
core's memory (paper §4.2, §4.3.1).  Each set has a fixed physical byte
budget (``ways * 128`` bytes, what the uncompressed layout holds).  With
compression, blocks occupy 32, 64 or 128 bytes by their BDI level, so a
set holds up to ``4 * ways`` logical blocks (paper Fig. 9); without it,
every block takes 128 bytes and this is a plain ``ways``-way set.  An
insert evicts LRU blocks until the new one fits (a 128-byte insert can
displace four 32-byte blocks).

Tensors follow ``core.tag_store``: tags as int32 uint32 bit patterns, LRU
counters as int32.  Each call returns a new state and leaves its input
untouched, as the reference's do; only the tests call these.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .compression import BLOCK_BYTES
from .tag_store import LRU_MAX, Index, replace_row, tag32, touched_lru

MAX_EVICTIONS = 4  # 128 B insert / 32 B min victim


class ExtCacheState(NamedTuple):
    tags: torch.Tensor   # (num_sets, max_ways) int32 uint32 bit pattern
    valid: torch.Tensor  # (num_sets, max_ways) bool
    dirty: torch.Tensor  # (num_sets, max_ways) bool
    lru: torch.Tensor    # (num_sets, max_ways) int32
    size: torch.Tensor   # (num_sets, max_ways) int32: physical bytes
    used: torch.Tensor   # (num_sets,) int32: physical bytes occupied


class ExtInsertResult(NamedTuple):
    way: torch.Tensor         # () int64
    evictions: torch.Tensor   # () int32: valid blocks displaced
    writebacks: torch.Tensor  # () int32: of those, dirty ones


def make_state(num_sets: int, ways: int, *, compression: bool,
               device="cpu") -> ExtCacheState:
    max_ways = ways * (BLOCK_BYTES // 32) if compression else ways
    z = torch.zeros((num_sets, max_ways), dtype=torch.int32, device=device)
    f = torch.zeros((num_sets, max_ways), dtype=torch.bool, device=device)
    return ExtCacheState(tags=z, valid=f, dirty=f.clone(), lru=z.clone(),
                         size=z.clone(),
                         used=torch.zeros(num_sets, dtype=torch.int32,
                                          device=device))


def set_budget_bytes(ways: int) -> int:
    return ways * BLOCK_BYTES


def lookup(state: ExtCacheState, set_idx: Index, tag
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hit, way): valid and tag match, the first matching way."""
    s = int(set_idx)
    match = state.valid[s] & (state.tags[s] == tag32(tag, state.tags.device))
    return match.any(), torch.argmax(match.to(torch.int32))


def touch(state: ExtCacheState, set_idx: Index, way, *,
          write: bool = False) -> ExtCacheState:
    s = int(set_idx)
    onehot = torch.arange(state.lru.shape[1],
                          device=state.lru.device) == int(way)
    return replace_row(state, s, lru=touched_lru(state.lru[s], onehot),
                       dirty=state.dirty[s] | (onehot & bool(write)))


def insert(state: ExtCacheState, set_idx: Index, tag, phys_bytes,
           budget: int, *, write: bool = False
           ) -> Tuple[ExtCacheState, ExtInsertResult]:
    """Insert a block of ``phys_bytes`` into set ``set_idx``, evicting the
    LRU valid block while it does not fit in ``budget`` bytes (at most
    ``MAX_EVICTIONS`` times), then placing it in the first invalid way
    (paper §4.2.1 miss handling, §4.3.1 compressed layout)."""
    s = int(set_idx)
    tags, valid, dirty, lru, size = (a[s].clone() for a in state[:5])
    used = int(state.used[s])
    phys = int(phys_bytes)
    ways = lru.shape[0]
    evictions = writebacks = 0
    for _ in range(MAX_EVICTIONS):
        if used + phys <= budget or not bool(valid.any()):
            break
        v = int(torch.argmin(torch.where(valid, lru.to(torch.int64),
                                         LRU_MAX + 1)))
        evictions += 1
        writebacks += int(dirty[v])
        used -= int(size[v])
        valid[v] = dirty[v] = False
        size[v] = 0
    free_way = torch.argmax((~valid).to(torch.int32))
    onehot = torch.arange(ways, device=lru.device) == free_way
    new = replace_row(
        state, s,
        tags=torch.where(onehot, tag32(tag, tags.device), tags),
        valid=valid | onehot,
        dirty=torch.where(onehot, bool(write), dirty),
        size=torch.where(onehot, phys, size),
        lru=touched_lru(lru, onehot),
        used=used + phys)
    return new, ExtInsertResult(
        way=free_way, evictions=torch.tensor(evictions, dtype=torch.int32),
        writebacks=torch.tensor(writebacks, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Capacity accounting (paper §5 characterization analogue)
# ---------------------------------------------------------------------------

def capacity_per_cache_chip(*, vmem_budget_bytes: int, hbm_budget_bytes: int,
                            aux_fraction: float = 0.09) -> dict:
    """Usable extended-cache bytes one cache-mode chip contributes: the
    on-chip budget less the auxiliary registers' share (the paper's RTX
    3080 kept 7-9 % of its register file for them), plus the bulk pool."""
    vmem = int(vmem_budget_bytes * (1.0 - aux_fraction))
    return {"vmem_bytes": vmem, "hbm_bytes": hbm_budget_bytes,
            "total_bytes": vmem + hbm_budget_bytes}
