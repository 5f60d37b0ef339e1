"""Set-associative tag store with LRU counters, valid and dirty bits,
after ``repro.core.tag_store``.

The functional model of the metadata the extended-LLC kernel keeps in the
metadata register (paper Fig. 8 (3)-(4), (7)): per block an LRU counter,
a dirty bit, a valid bit and the tag.  LRU semantics follow paper
Algorithm 1 lines 8-12: on an access the way's counter is reset to
``LRU_MAX``, every other way's counter is decremented (saturating at 0),
and the replacement victim is the way with the least counter, invalid
ways first.  The engine's transition lives in ``core.controller``; only
the tests call the functions here, as in the reference.

State lives in (num_sets, ways) tensors: tags as int32 holding the
uint32 bit pattern (the port's convention, ``_u32``), LRU counters as
int32 (they never exceed ``LRU_MAX``).  Each call returns a new state and
leaves its input untouched, as the reference's do.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from .. import _u32

LRU_MAX = 0xFFF  # paper Algorithm 1 line 9
# the same value as a plain int, under the reference's name: the online
# runtime's handoff writes ``LRU_MAX_INT - k`` into rebuilt rows
LRU_MAX_INT = LRU_MAX

Index = Union[int, torch.Tensor]


class TagStoreState(NamedTuple):
    tags: torch.Tensor    # (num_sets, ways) int32 uint32 bit pattern
    valid: torch.Tensor   # (num_sets, ways) bool
    dirty: torch.Tensor   # (num_sets, ways) bool
    lru: torch.Tensor     # (num_sets, ways) int32 decrementing counters


class LookupResult(NamedTuple):
    hit: torch.Tensor     # () bool
    way: torch.Tensor     # () int64: the hit way (valid only on a hit)


class InsertResult(NamedTuple):
    way: torch.Tensor            # () int64: the way written
    evicted_valid: torch.Tensor  # () bool: a valid block was evicted
    evicted_dirty: torch.Tensor  # () bool: ... and it was dirty
    evicted_tag: torch.Tensor    # () int32 uint32 bit pattern


def make_state(num_sets: int, ways: int, device="cpu") -> TagStoreState:
    z = torch.zeros((num_sets, ways), dtype=torch.int32, device=device)
    f = torch.zeros((num_sets, ways), dtype=torch.bool, device=device)
    return TagStoreState(tags=z, valid=f, dirty=f.clone(), lru=z.clone())


def tag32(tag, device) -> torch.Tensor:
    """A tag (a Python int in [0, 2^32) or a tensor) as an int32 bit
    pattern."""
    return _u32.to_i32(torch.as_tensor(tag, device=device).to(torch.int64))


def replace_row(state: NamedTuple, s: int, **rows) -> NamedTuple:
    """``state`` with row ``s`` of the named fields replaced (copies)."""
    new = {}
    for name, row in rows.items():
        a = getattr(state, name).clone()
        a[s] = row
        new[name] = a
    return state._replace(**new)


def touched_lru(lru: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """The accessed way to ``LRU_MAX``, every other decremented, saturating
    at 0."""
    return torch.where(onehot, LRU_MAX, lru.clamp_min(1) - 1).to(lru.dtype)


def lookup(state: TagStoreState, set_idx: Index, tag) -> LookupResult:
    """Tag lookup (Algorithm 1 lines 2-7): valid and tag match per way, the
    first matching way.  A pure query; the LRU update is ``touch``."""
    s = int(set_idx)
    match = state.valid[s] & (state.tags[s] == tag32(tag, state.tags.device))
    return LookupResult(hit=match.any(), way=torch.argmax(match.to(
        torch.int32)))


def touch(state: TagStoreState, set_idx: Index, way, *,
          write: bool = False) -> TagStoreState:
    """LRU update on a hit (Algorithm 1 lines 8-12); a write hit sets the
    dirty bit."""
    s = int(set_idx)
    ways = state.lru.shape[1]
    onehot = torch.arange(ways, device=state.lru.device) == int(way)
    return replace_row(state, s, lru=touched_lru(state.lru[s], onehot),
                       dirty=state.dirty[s] | (onehot & bool(write)))


def _victim_row(valid: torch.Tensor, lru: torch.Tensor) -> torch.Tensor:
    return torch.argmin(torch.where(valid, lru.to(torch.int64), -1))


def victim(state: TagStoreState, set_idx: Index) -> torch.Tensor:
    """The LRU victim way: invalid ways first, else the least counter."""
    s = int(set_idx)
    return _victim_row(state.valid[s], state.lru[s])


def insert(state: TagStoreState, set_idx: Index, tag, *,
           write: bool = False) -> Tuple[TagStoreState, InsertResult]:
    """Fill a block after a miss: the LRU victim's writeback need, then the
    new tag installed as MRU."""
    s = int(set_idx)
    tags, valid, dirty, lru = (a[s] for a in state)
    w = _victim_row(valid, lru)
    onehot = torch.arange(lru.shape[0], device=lru.device) == w
    result = InsertResult(way=w, evicted_valid=valid[w],
                          evicted_dirty=valid[w] & dirty[w],
                          evicted_tag=tags[w].clone())
    new = replace_row(
        state, s,
        tags=torch.where(onehot, tag32(tag, tags.device), tags),
        valid=valid | onehot,
        dirty=torch.where(onehot, bool(write), dirty),
        lru=touched_lru(lru, onehot))
    return new, result


def occupancy(state: TagStoreState) -> torch.Tensor:
    """Fraction of valid blocks (diagnostic)."""
    return state.valid.float().mean()
