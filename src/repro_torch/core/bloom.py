"""Double-Bloom-filter hit/miss predictor (paper §4.1.2, Fig. 6), after
``repro.core.bloom``.

Per extended-LLC set two filters: ``BF1`` holds at least every block
resident in the set (so a query never gives a false negative), ``BF2``
the ``n`` most recently used blocks; once ``n`` reaches the
associativity, BF2 becomes BF1 and an empty filter starts collecting
("clear, swap, repeat", Fig. 6 (9)).  The counting Bloom filter of the
paper's footnote 2 (per-element removal at 4x the bits) sits beside it
for the ablation the reference tests.

A filter is ``words`` uint32 words (paper: 32 B = 8 words), stored as an
int32 bit-pattern tensor with the words on the last dimension.
``NUM_HASHES`` multiply-shift hashes set and test one bit each.  The
primitives (``_hash_bits``, ``_bit_mask``, ``_test``) broadcast over
leading dimensions and are what the engine and the pool use; the
predictor's state functions take one set and one tag a call and return a
new state, leaving their input untouched, as the reference's do (only
the tests call them).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .. import _u32

# Multiply-shift hash constants (large odd 32-bit multipliers), as in the
# reference; the CUDA kernel repeats the first NUM_HASHES of them.
_HASH_MULTIPLIERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
NUM_HASHES = 3


def _hash_bits(tag: torch.Tensor, num_bits: int) -> torch.Tensor:
    """(..., NUM_HASHES) int64 bit positions (< ``num_bits``) of ``tag``."""
    t = _u32.to_u(tag)
    hs = []
    for m in _HASH_MULTIPLIERS[:NUM_HASHES]:
        hm = _u32.mul(t, m)
        hs.append(hm ^ _u32.shr(hm, 15))
    return torch.stack(hs, dim=-1) % num_bits


def _bit_mask(bits: torch.Tensor, words: int) -> torch.Tensor:
    """Expand bit positions (..., k) into a (..., words) OR-mask."""
    word_ids = torch.arange(words, device=bits.device)
    mask = torch.zeros(bits.shape[:-1] + (words,), dtype=torch.int64,
                       device=bits.device)
    for i in range(bits.shape[-1]):
        b = bits[..., i:i + 1]
        mask = mask | torch.where(word_ids == b // 32,
                                  torch.ones_like(b) << (b % 32), 0)
    return _u32.to_i32(mask)


def _test(filter_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """True iff all hash bits are set in the filter (possible membership)."""
    w = _u32.to_u(torch.gather(filter_words, -1, bits // 32))
    return (((w >> (bits % 32)) & 1) == 1).all(dim=-1)


# ------------------------------------------------------------ predictor

class BloomPredictorState(NamedTuple):
    """Predictor state for ``num_sets`` extended-LLC sets."""
    bf1: torch.Tensor            # (num_sets, words) int32: prediction filter
    bf2: torch.Tensor            # (num_sets, words) int32: MRU collector
    n_mru: torch.Tensor          # (num_sets,) int32: the paper's n a set
    associativity: torch.Tensor  # () int32: the swap threshold
    queries: torch.Tensor        # () int32 counters from here on
    predicted_hits: torch.Tensor
    swaps: torch.Tensor


def make_state(num_sets: int, associativity: int, *, filter_bytes: int = 32,
               device="cpu") -> BloomPredictorState:
    words = filter_bytes // 4
    if words < 1:
        raise ValueError("filter_bytes must be >= 4")
    zeros = torch.zeros((num_sets, words), dtype=torch.int32, device=device)
    scalar = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                    device=device)
    return BloomPredictorState(
        bf1=zeros, bf2=zeros.clone(),
        n_mru=torch.zeros(num_sets, dtype=torch.int32, device=device),
        associativity=scalar(associativity), queries=scalar(0),
        predicted_hits=scalar(0), swaps=scalar(0))


def _tag_bits(state: BloomPredictorState, tag) -> torch.Tensor:
    words = state.bf1.shape[1]
    t = _u32.to_i32(torch.as_tensor(tag, device=state.bf1.device).to(
        torch.int64))
    return _hash_bits(t, words * 32)


def predict(state: BloomPredictorState, set_idx, tag
            ) -> Tuple[torch.Tensor, BloomPredictorState]:
    """Paper Fig. 6(a): a predicted hit iff the tag may be in BF1 (no
    false negatives, by invariant (1))."""
    hit = _test(state.bf1[int(set_idx)], _tag_bits(state, tag))
    return hit, state._replace(
        queries=state.queries + 1,
        predicted_hits=state.predicted_hits + hit.to(torch.int32))


def record_access(state: BloomPredictorState, set_idx, tag
                  ) -> BloomPredictorState:
    """Paper Fig. 6(b): on every extended-LLC access insert the tag into
    both filters (7); ``n`` counts it if it was not in BF2 already; at
    ``n >= associativity`` BF2 becomes BF1, BF2 empties and ``n`` is 0
    (8)-(9)."""
    s = int(set_idx)
    words = state.bf1.shape[1]
    bits = _tag_bits(state, tag)
    mask = _bit_mask(bits, words)
    was_in_bf2 = bool(_test(state.bf2[s], bits))
    bf1, bf2, n_mru = state.bf1.clone(), state.bf2.clone(), state.n_mru.clone()
    row1, row2 = bf1[s] | mask, bf2[s] | mask
    n = int(n_mru[s]) + (0 if was_in_bf2 else 1)
    swap = n >= int(state.associativity)
    bf1[s] = row2 if swap else row1
    bf2[s] = torch.zeros_like(row2) if swap else row2
    n_mru[s] = 0 if swap else n
    return state._replace(bf1=bf1, bf2=bf2, n_mru=n_mru,
                          swaps=state.swaps + int(swap))


def false_positive_rate(filter_bytes: int, num_elements: int,
                        num_hashes: int = NUM_HASHES) -> float:
    """The analytic Bloom false-positive rate (the paper's sizing check:
    32 B at associativity about 32)."""
    m = filter_bytes * 8
    n = max(num_elements, 1)
    return (1.0 - math.exp(-num_hashes * n / m)) ** num_hashes


# -------------------------------------------------- counting Bloom filter
# The paper's footnote-2 alternative: per-element removal on eviction
# tracks residency exactly (modulo counter saturation), with no BF2/swap
# machinery, at 4 bits a counter: 4x the storage of a plain filter with
# the same number of cells.

class CountingBloomState(NamedTuple):
    counters: torch.Tensor   # (num_sets, cells) uint8, saturating at 15
    cells: torch.Tensor      # () int32


def make_counting_state(num_sets: int, *, filter_bytes: int = 32,
                        device="cpu") -> CountingBloomState:
    """``filter_bytes`` of 4-bit counters: 2 cells a byte."""
    cells = filter_bytes * 2
    return CountingBloomState(
        counters=torch.zeros((num_sets, cells), dtype=torch.uint8,
                             device=device),
        cells=torch.tensor(cells, dtype=torch.int32, device=device))


def _counting_cells(st: CountingBloomState, tag) -> torch.Tensor:
    t = _u32.to_i32(torch.as_tensor(tag, device=st.counters.device).to(
        torch.int64))
    return _hash_bits(t, st.counters.shape[-1]).tolist()


def counting_insert(st: CountingBloomState, set_idx, tag
                    ) -> CountingBloomState:
    s = int(set_idx)
    counters = st.counters.clone()
    for i in _counting_cells(st, tag):
        counters[s, i] = min(int(counters[s, i]) + 1, 15)
    return st._replace(counters=counters)


def counting_remove(st: CountingBloomState, set_idx, tag
                    ) -> CountingBloomState:
    """Removal on eviction, the capability plain filters lack.  Saturated
    counters (15) stay: decrementing them could give false negatives."""
    s = int(set_idx)
    counters = st.counters.clone()
    for i in _counting_cells(st, tag):
        c = int(counters[s, i])
        if 0 < c < 15:
            counters[s, i] = c - 1
    return st._replace(counters=counters)


def counting_query(st: CountingBloomState, set_idx, tag) -> torch.Tensor:
    row = st.counters[int(set_idx)]
    return torch.tensor(all(int(row[i]) > 0
                            for i in _counting_cells(st, tag)))
