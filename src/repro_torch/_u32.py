"""Mod-2^32 arithmetic on int64 tensors.

The port stores uint32 quantities (tags, LRU counters, Bloom words) as
int32 tensors holding the uint32 bit pattern.  PyTorch on the CPU has
uint32 tensors but raises ``NotImplementedError`` for ``>>``, ``-``,
``<=``, ``torch.maximum`` and ``argmin`` on them, so the plain path widens
to int64 (``to_u``), computes there, and narrows back (``to_i32``).
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_SIGN = 0x80000000


def to_u(x: torch.Tensor) -> torch.Tensor:
    """uint32 value of ``x`` (an int32 bit pattern or an int64) as int64
    in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as an int32 bit pattern."""
    return (((x & MASK) ^ _SIGN) - _SIGN).to(torch.int32)


def mul(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m mod 2^32`` for ``a`` in [0, 2^32) and a 32-bit constant
    ``m``; split in 16-bit halves so no int64 product overflows."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical shift right of a value in [0, 2^32)."""
    return a >> k


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a < b`` of two int32 bit patterns."""
    return to_u(a) < to_u(b)


def sat_dec(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 1) - 1`` on a uint32 bit pattern (int32 in, int32 out)."""
    return to_i32(to_u(x).clamp_min(1) - 1)
