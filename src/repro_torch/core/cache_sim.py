"""Trace-driven GPU system model: the paper's nine evaluated systems (§6),
after ``repro.core.cache_sim``.

Combines the set-parallel engine's Stats with an analytical
execution-time model:

    t_compute = insts / (n_compute * IPC_core * f)
    t_bw      = max(dram_bytes/BW_dram, conv_bytes/BW_conv, noc_bytes/BW_noc,
                    ext_bytes/(n_cache * BW_ext_core))
    t_lat     = sum(request latencies) / MLP,  MLP = n_compute * mlp_per_core
    t_exec    = max(t_compute, t_bw, t_lat)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import obs
from . import address_separation as asep
from . import engine
from . import traces as tr
from .controller import MorpheusConfig, Predictor, Stats
from .energy import PaperGPU

# --- baseline machine constants (RTX 3080-like, Table 1) -------------------
TOTAL_CORES = 68
FREQ_GHZ = 1.44
IPC_PER_CORE = 1.0          # warp-instructions/cycle/SM sustained
MLP_PER_CORE = 128.0        # outstanding memory requests per SM
CONV_LLC_BYTES = 5 * (1 << 20)
SIM_SCALE = 8               # simulate a 1/8-scale memory system
CONV_WAYS = 32
LLC_PARTITIONS = 10
EXT_BYTES_PER_CORE = 328 * 1024     # §5 'Combining': RF(32w) + L1(16w)
EXT_WAYS = 32
EXT_SET_BYTES = EXT_WAYS * tr.BLOCK_BYTES
EXT_SETS_PER_CORE = EXT_BYTES_PER_CORE // EXT_SET_BYTES     # 82
BW_DRAM = 760e9
BW_CONV = LLC_PARTITIONS * 120e9    # effective conventional-LLC bandwidth
BW_NOC = 1.5e12
BW_EXT_CORE = 34e9          # §5: per cache-mode core
MAX_CACHE_FRAC = 0.75       # §4.1.3: up to 75% of SMs in cache mode


@dataclass(frozen=True)
class SystemSpec:
    name: str
    conv_scale: float = 1.0          # conventional LLC capacity multiplier
    morpheus: bool = False
    compression: bool = False
    indirect_mov: bool = False
    predictor: Predictor = Predictor.BLOOM
    mem_boost: float = 1.0           # Frequency-Boost: BW*, 1/latency*
    unified_extra_bytes: int = 0     # Unified-SM-Mem: extra per-core filter


SYSTEMS: Dict[str, SystemSpec] = {
    "BL": SystemSpec("BL"),
    "IBL": SystemSpec("IBL"),
    "IBL-4x-LLC": SystemSpec("IBL-4x-LLC", conv_scale=4.0),
    "Frequency-Boost": SystemSpec("Frequency-Boost", mem_boost=1.15),
    "Unified-SM-Mem": SystemSpec("Unified-SM-Mem",
                                 unified_extra_bytes=232 * 1024),
    "Morpheus-Basic": SystemSpec("Morpheus-Basic", morpheus=True),
    "Morpheus-Compression": SystemSpec("Morpheus-Compression", morpheus=True,
                                       compression=True),
    "Morpheus-Indirect-MOV": SystemSpec("Morpheus-Indirect-MOV", morpheus=True,
                                        indirect_mov=True),
    "Morpheus-ALL": SystemSpec("Morpheus-ALL", morpheus=True,
                               compression=True, indirect_mov=True),
}


def build_config(spec: SystemSpec, n_cache: int) -> MorpheusConfig:
    conv_bytes = int(CONV_LLC_BYTES * spec.conv_scale) // SIM_SCALE
    conv_sets = max(conv_bytes // (CONV_WAYS * tr.BLOCK_BYTES), 16)
    n_cache = n_cache if spec.morpheus else 0
    sets_per_chip = max(EXT_SETS_PER_CORE // SIM_SCALE, 2)
    amap = asep.make_map(conv_sets=conv_sets, num_cache_chips=n_cache,
                         sets_per_chip=sets_per_chip)
    return MorpheusConfig(amap=amap, conv_ways=CONV_WAYS, ext_ways=EXT_WAYS,
                          compression=spec.compression,
                          predictor=spec.predictor,
                          indirect_mov=spec.indirect_mov)


def _unified_filter(addrs: np.ndarray, writes: np.ndarray, levels: np.ndarray,
                    n_cores: int, extra_bytes: int):
    """Unified-SM-Mem: absorb accesses that hit a per-core direct-mapped
    filter of the extra unified capacity (approximation of a bigger L1)."""
    sets = max(extra_bytes // tr.BLOCK_BYTES, 1)
    core = np.arange(len(addrs)) % max(n_cores, 1)
    set_idx = addrs % sets
    key = core.astype(np.uint64) * np.uint64(1 << 32) + set_idx.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    sk, sa = key[order], addrs[order]
    hit_sorted = np.zeros(len(addrs), dtype=bool)
    same_slot = sk[1:] == sk[:-1]
    hit_sorted[1:] = same_slot & (sa[1:] == sa[:-1])
    hit = np.zeros_like(hit_sorted)
    hit[order] = hit_sorted
    keep = ~hit
    return addrs[keep], writes[keep], levels[keep]


@dataclass
class RunResult:
    app: str
    system: str
    n_compute: int
    n_cache: int
    exec_time_s: float
    ipc: float
    perf_per_watt: float
    stats: Stats              # numpy scalar leaves
    llc_hit_rate: float
    mpki: float
    dram_GBps: float
    noc_GBps: float
    llc_throughput_GBps: float
    energy_J: float

    @property
    def llc_accesses(self) -> int:
        s = self.stats
        return int(s.conv_hits + s.conv_misses + s.ext_hits + s.ext_true_miss)


@dataclass(frozen=True)
class RunPoint:
    """One (app, system, mode-split, trace) grid point for ``run_batch``.

    ``overrides`` is a sorted tuple of ``(field, value)`` pairs applied to
    the ``MorpheusConfig`` after ``build_config`` (fields: ``conv_ways``,
    ``ext_ways``, ``compression``, ``predictor`` (the enum or its string
    value), ``indirect_mov``).  The device is an argument of ``run_batch``,
    not of the point."""
    app: str
    system: str
    n_compute: int
    n_cache: int = 0
    length: int = 120_000
    seed: int = 0
    overrides: Tuple[Tuple[str, object], ...] = ()


_OVERRIDABLE = ("conv_ways", "ext_ways", "compression", "predictor",
                "indirect_mov")


def apply_overrides(cfg: MorpheusConfig,
                    overrides: Tuple[Tuple[str, object], ...]
                    ) -> MorpheusConfig:
    """Apply a ``RunPoint.overrides`` tuple to a built config; an unknown
    field raises ``ValueError``."""
    if not overrides:
        return cfg
    kw = {}
    for field_name, value in overrides:
        if field_name not in _OVERRIDABLE:
            raise ValueError(f"override of {field_name!r} not supported "
                             f"(allowed: {_OVERRIDABLE})")
        if field_name == "predictor" and not isinstance(value, Predictor):
            value = Predictor(value)
        if field_name in ("conv_ways", "ext_ways"):
            value = int(value)
        if field_name in ("compression", "indirect_mov"):
            value = bool(value)
        kw[field_name] = value
    return replace(cfg, **kw)


def _prepare(pt: RunPoint):
    """Resolve a point: mode-split overrides, trace generation, config.

    Returns (cfg, trace-tuple-for-engine, resolved n_compute/n_cache,
    post-warmup access count)."""
    spec = SYSTEMS[pt.system]
    w = tr.WORKLOADS[pt.app]
    n_compute, n_cache = pt.n_compute, pt.n_cache
    if not w.memory_bound and spec.morpheus:
        n_cache = 0   # §7.1 obs. 5: all cores stay in compute mode
        n_compute = TOTAL_CORES

    addrs, writes, levels = tr.generate(pt.app, n_cores=n_compute,
                                        length=pt.length, seed=pt.seed,
                                        ws_scale=1.0 / SIM_SCALE)
    if spec.unified_extra_bytes:
        addrs, writes, levels = _unified_filter(addrs, writes, levels,
                                                n_compute,
                                                spec.unified_extra_bytes)
    cfg = apply_overrides(build_config(spec, n_cache), pt.overrides)
    # exclude the compulsory-miss warmup (one pass over the working set,
    # capped at half the trace) so stats reflect steady state
    ws_blocks = w.working_set_bytes // SIM_SCALE // tr.BLOCK_BYTES
    warmup = int(min(len(addrs) // 2, ws_blocks))
    return (cfg, (addrs, writes, levels, warmup), n_compute, n_cache,
            len(addrs) - warmup)


def _finalize(pt: RunPoint, n_compute: int, n_cache: int, n_acc: int,
              stats: Stats, *, insts: float | None = None,
              knee: float | None = None) -> RunResult:
    """Analytical execution-time / power model on top of simulated Stats
    (host-side floats; ``insts``/``knee`` override the app profile's)."""
    app, spec = pt.app, SYSTEMS[pt.system]
    w = tr.WORKLOADS[app]
    if insts is None:
        insts = tr.instructions_for(app, n_acc)
    if knee is None:
        knee = w.contention_knee
    gpu = PaperGPU()

    boost = spec.mem_boost
    t_compute = insts / (n_compute * IPC_PER_CORE * FREQ_GHZ * 1e9)
    # DRAM row-buffer locality: interleaving more streams than the app's
    # knee degrades effective DRAM bandwidth (the Fig. 1 'drop' mechanism)
    row_locality = max(0.2, min(1.0, knee / max(n_compute, 1)))
    t_dram = float(stats.dram_bytes) / (BW_DRAM * boost * row_locality)
    t_conv = float(stats.conv_bytes) / (BW_CONV * boost)
    t_noc = float(stats.noc_bytes) / (BW_NOC * boost)
    # §4.3.2: the native Indirect-MOV instruction raises the helper
    # kernel's service throughput per cache-mode core
    ext_bw = BW_EXT_CORE * (1.15 if spec.indirect_mov else 1.0)
    t_ext = (float(stats.noc_bytes) / (max(n_cache, 1) * ext_bw)
             if spec.morpheus and n_cache else 0.0)
    t_lat = float(stats.latency_ns) * 1e-9 / (boost * n_compute * MLP_PER_CORE)
    t_exec = max(t_compute, t_dram, t_conv, t_noc, t_ext, t_lat)

    ipc = insts / (t_exec * FREQ_GHZ * 1e9) if t_exec > 0 else 0.0

    mem_energy_J = float(stats.energy_nJ) * 1e-9
    power = gpu.static_power_W + gpu.core_power_W * (n_compute + n_cache)
    if spec.morpheus:
        power *= 1.0 + gpu.controller_power_frac
    power += mem_energy_J / max(t_exec, 1e-12)
    energy_J = power * t_exec
    ppw = ipc / power

    hits = float(stats.conv_hits + stats.ext_hits)
    total = float(hits + stats.conv_misses + stats.ext_true_miss)
    llc_bytes = float(stats.conv_bytes + stats.noc_bytes)
    return RunResult(
        app=app, system=pt.system, n_compute=n_compute, n_cache=n_cache,
        exec_time_s=t_exec, ipc=ipc, perf_per_watt=ppw, stats=stats,
        llc_hit_rate=hits / max(total, 1.0),
        mpki=1000.0 * float(stats.conv_misses + stats.ext_true_miss)
        / max(insts, 1.0),
        dram_GBps=float(stats.dram_bytes) / max(t_exec, 1e-12) / 1e9,
        noc_GBps=float(stats.noc_bytes) / max(t_exec, 1e-12) / 1e9,
        llc_throughput_GBps=llc_bytes / max(t_exec, 1e-12) / 1e9,
        energy_J=energy_J,
    )


# ------------------------------------------------------------ batched sweep

# Points per engine dispatch.  The last chunk of a config-group is padded
# (by repeating its final trace) to a power of two.
BATCH_CHUNK = 16


def _chunk_lengths(n: int) -> List[int]:
    out = [BATCH_CHUNK] * (n // BATCH_CHUNK)
    rem = n % BATCH_CHUNK
    if rem:
        out.append(engine._bucket(rem, minimum=1))
    return out


def run_batch(points: Sequence[RunPoint], device=None) -> List[RunResult]:
    """Run many grid points through the set-parallel engine, batched.

    Points are grouped by simulator config; each group becomes engine
    dispatches of up to ``BATCH_CHUNK`` traces.  Results come back in
    input order.  ``device=None`` runs on the CUDA card (``BackendError``
    without one); ``device="cpu"`` runs the plain PyTorch version."""
    dev = engine.resolve_device(device)
    prepped = [_prepare(pt) for pt in points]
    groups: Dict[MorpheusConfig, List[int]] = {}
    for i, (cfg, _, _, _, _) in enumerate(prepped):
        groups.setdefault(cfg, []).append(i)

    results: List[RunResult] = [None] * len(points)  # type: ignore
    with obs.span("cache_sim.run_batch", points=len(points),
                  groups=len(groups)):
        for cfg, idxs in groups.items():
            done = 0
            for blen in _chunk_lengths(len(idxs)):
                chunk = idxs[done:done + blen]
                done += len(chunk)
                traces = [prepped[i][1] for i in chunk]
                while len(traces) < blen:     # pad to the batch shape
                    traces.append(traces[-1])
                stats_b = [x.cpu().numpy()
                           for x in engine.simulate_batch(cfg, traces, dev)]
                for j, i in enumerate(chunk):
                    stats = Stats(*[x[j] for x in stats_b])
                    _, _, n_compute, n_cache, n_acc = prepped[i]
                    results[i] = _finalize(points[i], n_compute, n_cache,
                                           n_acc, stats)
    return results


def run(app: str, system: str, *, n_compute: int, n_cache: int = 0,
        length: int = 120_000, seed: int = 0, device=None) -> RunResult:
    """Single-point wrapper over ``run_batch``."""
    return run_batch([RunPoint(app, system, n_compute, n_cache,
                               length, seed)], device)[0]
