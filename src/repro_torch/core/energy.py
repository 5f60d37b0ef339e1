"""Latency and energy constants (copy of ``repro.core.energy``'s
``TierCosts``, ``PaperGPU`` and ``TPUv5e``).

All latencies in ns, energies in pJ/B, bandwidths in B/s.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TierCosts:
    hit_latency_ns: float
    miss_latency_ns: float          # latency of a miss *serviced below*
    bandwidth_Bps: float
    energy_pJ_per_B: float


@dataclass(frozen=True)
class PaperGPU:
    """Constants from the paper (Figs. 5, 11; §5 text; §7.5)."""

    # conventional LLC: ~160 ns hit, 608 ns miss (DRAM), ~300 GB/s/partition
    conv_llc: TierCosts = TierCosts(160.0, 608.0, 300e9, 10.0)
    # extended LLC (register file + L1, 32+16 warps, §5 'Combining'):
    # 185 ns kernel-side + interconnect => ~300 ns effective hit; miss 773 ns
    ext_llc: TierCosts = TierCosts(300.0, 773.0, 34e9, 61.0)
    # off-chip GDDR6X
    dram: TierCosts = TierCosts(608.0, 608.0, 760e9, 170.0)
    # per-chip-cache-mode capacity (bytes): register file + L1 combined
    # (§5: 328 KiB per cache-mode SM)
    ext_capacity_per_core: int = 328 * 1024
    # predicted-miss path: as fast as a conventional miss (Fig. 5)
    predicted_miss_latency_ns: float = 608.0
    # Morpheus controller adders (§7.5)
    controller_power_frac: float = 0.0093
    controller_storage_bytes: int = 21 * 1024
    # GPU-level power model (W) for perf/W: rough RTX 3080 components
    core_power_W: float = 3.2          # per active SM
    static_power_W: float = 60.0


@dataclass(frozen=True)
class TPUv5e:
    """The reference's serving-tier cost model (``repro.core.energy``).

    These are inputs of the reference's modeled costs, not measurements
    of any chip: ``serving.paged_kv`` sums ``local_hbm``/``remote_hbm``
    latencies into ``PoolStats.time_ns``, so the port carries the same
    values for its Stats to equal the reference's."""

    peak_flops_bf16: float = 197e12
    hbm_Bps: float = 819e9
    ici_Bps_per_link: float = 50e9
    # two-tier KV cache analogue costs
    local_hbm: TierCosts = TierCosts(1_000.0, 5_000.0, 819e9, 4.0)
    remote_hbm: TierCosts = TierCosts(4_000.0, 9_000.0, 50e9, 12.0)
    host_offload: TierCosts = TierCosts(50_000.0, 50_000.0, 8e9, 60.0)
    vmem_bytes: int = 128 * 1024 * 1024
    hbm_bytes: int = 16 * (1 << 30)
