"""Double-Bloom-filter predictor primitives (paper §4.1.2), after
``repro.core.bloom``.

A filter is ``words`` uint32 words (paper: 32 B = 8 words), stored as an
int32 bit-pattern tensor with the words on the last dimension.
``NUM_HASHES`` multiply-shift hashes set and test one bit each.  All three
functions broadcast over leading dimensions.
"""
from __future__ import annotations

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
