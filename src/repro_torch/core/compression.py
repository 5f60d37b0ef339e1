"""Base-Delta-Immediate cache compression (paper §4.3.1), after
``repro.core.compression``: the reference semantics, vectorised over
blocks.

Each 128-byte extended-LLC block is compressed with BDI over 4-byte
segments and classified into three levels: ``HIGH`` (deltas from the
base fit int8, 32 B payload), ``LOW`` (int16, 64 B) or ``UNCOMP``
(128 B, stored verbatim).  The base segment is stored out of line, so the
payload is deltas only.  The slots each level gets adapt per epoch from
level-frequency counters (``LevelAllocator``).

Blocks are (..., 32) int32 tensors holding the uint32 bit patterns (the
port's convention, ``_u32``); the arithmetic is mod 2^32, as the
reference's.  The serving pool's kernels (``kernels/pool.py``) carry
their own plain version of the compression; the engine reads only the
level codes and ``BLOCK_BYTES``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _u32

HIGH, LOW, UNCOMP = 0, 1, 2
LEVEL_BYTES = {HIGH: 32, LOW: 64, UNCOMP: 128}
BLOCK_BYTES = 128
SEGMENTS = BLOCK_BYTES // 4
_SLOT_COST = (1, 2, 4)   # 32-byte slots a block of each level takes


def _wrap_deltas(blocks: torch.Tensor) -> torch.Tensor:
    """Two's-complement deltas from the base segment as uint32 values in
    int64 (mod-2^32 subtract)."""
    u = _u32.to_u(blocks)
    return (u - u[..., :1]) & _u32.MASK


def _fits_signed(d: torch.Tensor, bits: int) -> torch.Tensor:
    """Does the two's-complement value ``d`` (uint32 in int64) fit in
    ``bits`` signed bits?"""
    return (d <= (1 << (bits - 1)) - 1) | (d >= (1 << 32) - (1 << (bits - 1)))


def classify(blocks: torch.Tensor) -> torch.Tensor:
    """Per-block level (...,) int32 in {HIGH, LOW, UNCOMP} of (..., 32)
    blocks."""
    d = _wrap_deltas(blocks)
    fits8 = _fits_signed(d, 8).all(-1)
    fits16 = _fits_signed(d, 16).all(-1)
    return torch.where(fits8, HIGH,
                       torch.where(fits16, LOW, UNCOMP)).to(torch.int32)


class Compressed(NamedTuple):
    level: torch.Tensor    # (...,) int32
    base: torch.Tensor     # (...,) int32 bit pattern: the base segment
    payload: torch.Tensor  # (..., 32) int32 bit patterns: the deltas (the
    #                        raw block for UNCOMP); the physical footprint
    #                        is LEVEL_BYTES[level]


def compress(blocks: torch.Tensor) -> Compressed:
    """Compress blocks; shape-stable, the physical size given by
    ``level``."""
    level = classify(blocks)
    deltas = _u32.to_i32(_wrap_deltas(blocks))
    payload = torch.where((level == UNCOMP)[..., None],
                          blocks.to(torch.int32), deltas)
    return Compressed(level=level, base=blocks[..., 0].to(torch.int32),
                      payload=payload)


def decompress(c: Compressed) -> torch.Tensor:
    """The exact inverse of ``compress`` (lossless at every level)."""
    restored = _u32.to_i32(_u32.to_u(c.base)[..., None]
                           + _u32.to_u(c.payload))
    return torch.where((c.level == UNCOMP)[..., None], c.payload, restored)


def physical_bytes(level: torch.Tensor) -> torch.Tensor:
    """Physical bytes of each block given its level."""
    return torch.where(level == HIGH, LEVEL_BYTES[HIGH], torch.where(
        level == LOW, LEVEL_BYTES[LOW], LEVEL_BYTES[UNCOMP])).to(torch.int32)


def compression_ratio(level: torch.Tensor) -> torch.Tensor:
    """Mean logical / physical ratio over a batch of blocks (f32)."""
    return (torch.tensor(float(BLOCK_BYTES))
            / physical_bytes(level).float().mean())


# ---------------------------------------------------------------------------
# Epoch-adaptive level capacity (paper §4.3.1: counters per epoch decide how
# many 32-byte slots each level gets; everything UNCOMP at first).
# ---------------------------------------------------------------------------

class LevelAllocator(NamedTuple):
    counts: torch.Tensor       # (3,) int64: blocks seen per level this epoch
    slots: torch.Tensor        # (3,) int32: the slot quota of each level
    epoch_len: torch.Tensor    # () int32
    tick: torch.Tensor         # () int32
    total_slots: torch.Tensor  # () int32: physical 32-byte slots


def make_allocator(total_bytes: int, epoch_len: int = 10_000
                   ) -> LevelAllocator:
    total_slots = total_bytes // 32
    return LevelAllocator(
        counts=torch.zeros(3, dtype=torch.int64),
        slots=torch.tensor([0, 0, total_slots], dtype=torch.int32),
        epoch_len=torch.tensor(epoch_len, dtype=torch.int32),
        tick=torch.zeros((), dtype=torch.int32),
        total_slots=torch.tensor(total_slots, dtype=torch.int32))


def allocator_observe(a: LevelAllocator, level) -> LevelAllocator:
    """Count one inserted or updated block; at the epoch's end share the
    slots out in proportion to the level mix weighted by slot cost (in
    f32, as the reference), the rounding remainder to UNCOMP."""
    counts = a.counts.clone()
    counts[int(level)] += 1
    tick = a.tick + 1
    if int(tick) < int(a.epoch_len):
        return a._replace(counts=counts, tick=tick)
    demand = counts.float() * torch.tensor(_SLOT_COST, dtype=torch.float32)
    frac = demand / demand.sum().clamp_min(1.0)
    slots = torch.floor(frac * a.total_slots.float()).to(torch.int32)
    slots[UNCOMP] += a.total_slots - slots.sum()
    return a._replace(counts=torch.zeros_like(counts), slots=slots,
                      tick=torch.zeros_like(tick))


def effective_capacity_blocks(a: LevelAllocator) -> torch.Tensor:
    """Logical 128-byte blocks the slots hold under the current split."""
    return (a.slots // torch.tensor(_SLOT_COST, dtype=torch.int32)).sum()
