"""Static address separation (paper §4.1.1), after
``repro.core.address_separation``.

The block-address space is split statically by set number: the first
``conv_sets`` global sets belong to the conventional LLC, the rest to the
extended tier, tiled block-contiguously over the cache-mode cores.  The
functions take block addresses as tensors holding uint32 values (an int32
bit pattern or a non-negative int64) and return int64 tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .. import _u32

# Tier codes
CONVENTIONAL = 0
EXTENDED = 1

# Extended-tier memory-unit codes (paper: register file / shared / L1)
UNIT_VMEM = 0   # fast unit (paper: register file)
UNIT_HBM = 1    # bulk unit (paper: unified L1/shared)


@dataclass(frozen=True)
class AddressMap:
    """Static parameters of the separation scheme.

    ``conv_sets``            sets in the conventional LLC
    ``ext_sets``             sets in the extended LLC (total over all owners)
    ``num_cache_chips``      cores in cache mode (0 => extended tier disabled)
    ``sets_per_chip``        ext sets owned by one cache-mode core
    ``vmem_sets_per_chip``   of those, how many live in the fast unit
    """

    conv_sets: int
    ext_sets: int
    num_cache_chips: int
    sets_per_chip: int
    vmem_sets_per_chip: int

    def __post_init__(self):
        if self.num_cache_chips > 0:
            if self.sets_per_chip * self.num_cache_chips != self.ext_sets:
                raise ValueError(
                    "extended sets must tile evenly over cache-mode cores")
            if not 0 <= self.vmem_sets_per_chip <= self.sets_per_chip:
                raise ValueError("vmem_sets_per_chip out of range")
        elif self.ext_sets != 0:
            raise ValueError("ext_sets must be 0 without cache-mode cores")

    @property
    def total_sets(self) -> int:
        return self.conv_sets + self.ext_sets


def make_map(*, conv_sets: int, num_cache_chips: int, sets_per_chip: int,
             vmem_fraction: float = 2.0 / 3.0) -> AddressMap:
    """Build an AddressMap.  ``vmem_fraction`` mirrors the paper's final
    split of 32 register-file warps vs. 16 L1 warps (§5, 'Combining')."""
    ext_sets = num_cache_chips * sets_per_chip
    vmem_sets = (int(round(sets_per_chip * vmem_fraction))
                 if num_cache_chips else 0)
    return AddressMap(conv_sets=conv_sets, ext_sets=ext_sets,
                      num_cache_chips=num_cache_chips,
                      sets_per_chip=sets_per_chip,
                      vmem_sets_per_chip=vmem_sets)


def set_index(amap: AddressMap, block_addr: torch.Tensor) -> torch.Tensor:
    """Global set number of a block address (modulo interleaving)."""
    return _u32.to_u(block_addr) % amap.total_sets


def tag_of(amap: AddressMap, block_addr: torch.Tensor) -> torch.Tensor:
    """Tag bits = block address / total_sets (the part not implied by set)."""
    return _u32.to_u(block_addr) // amap.total_sets


def route(amap: AddressMap, block_addr: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Controller routing: (tier, local_set_index)."""
    s = set_index(amap, block_addr)
    is_ext = s >= amap.conv_sets
    tier = torch.where(is_ext, EXTENDED, CONVENTIONAL)
    local = torch.where(is_ext, s - amap.conv_sets, s)
    return tier, local


def owner_of(amap: AddressMap, ext_set: torch.Tensor) -> torch.Tensor:
    """Which cache-mode core owns an extended set (core c owns sets
    [c*sets_per_chip, (c+1)*sets_per_chip))."""
    return ext_set // max(amap.sets_per_chip, 1)


def unit_of(amap: AddressMap, ext_set: torch.Tensor) -> torch.Tensor:
    """Memory unit within the owner core (paper §4.2 task 3): the first
    ``vmem_sets_per_chip`` sets of each core live in the fast unit."""
    within = ext_set % max(amap.sets_per_chip, 1)
    return torch.where(within < amap.vmem_sets_per_chip, UNIT_VMEM, UNIT_HBM)


def capacity_bytes(amap: AddressMap, ways: int, block_bytes: int
                   ) -> Tuple[int, int]:
    """(conventional, extended) data capacities implied by the map."""
    return (amap.conv_sets * ways * block_bytes,
            amap.ext_sets * ways * block_bytes)
