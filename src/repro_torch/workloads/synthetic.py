"""Synthetic LLC access-trace generators for the paper's 17 workloads.

A numpy-only copy of ``repro.workloads.synthetic``: the two packages
replay byte-identical traces (held so by the port's tests), so the port
needs no link to the reference at run time.

We cannot re-run Rodinia/Parboil CUDA binaries here, so each app is modeled
by a parameterized generator reproducing its *LLC-level* access structure:
working-set size, reuse pattern, write fraction, value compressibility and
arithmetic intensity.  Parameters were chosen so the *baseline* behaviours
match the paper's Fig. 1/2 qualitatively: which apps saturate early, which
thrash (kmeans/histo/mri-gri/spmv/lbm), and which gain most from 4x LLC.

Traces are per-core streams interleaved round-robin: more compute cores =>
more interleaved streams => longer reuse distances at the shared LLC,
which is the mechanism behind the paper's 'performance decreases after a
certain number of SMs' observation.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# BDI compressibility level codes — fixed by the paper's three-level
# scheme and mirrored from ``core.compression`` (HIGH/LOW/UNCOMP); the
# ``core.traces`` re-export checks the two stay equal at import time.
HIGH, LOW, UNCOMP = 0, 1, 2

BLOCK_BYTES = 128
MiB = 1 << 20

# Version of the generator semantics: bump whenever the traces produced
# for the SAME (app, n_cores, length, seed, ws_scale) change, so on-disk
# artifacts derived from traces (e.g. the benchmark policy caches) can
# detect staleness.  2 = crc32 app-seed (process-stable; 1 was the
# salted-hash(app) era).
TRACE_SCHEMA = 2


@dataclass(frozen=True)
class AppSpec:
    """Per-app trace-generator parameters (paper Table 2)."""
    name: str
    pattern: str              # streaming|sweep|powerlaw|stencil|tiles|wavefront|scatter|hotbins
    working_set_bytes: int
    write_frac: float
    # value compressibility mix (BDI): P(HIGH), P(LOW); rest UNCOMP
    p_high: float
    p_low: float
    # arithmetic intensity: warp-instructions executed per LLC access
    inst_per_access: float
    memory_bound: bool
    shared_dataset: bool = True   # cores sweep one dataset vs partitioned
    # DRAM row-buffer locality knee: interleaving more than this many core
    # streams destroys row locality (effective DRAM bandwidth falls).  The
    # paper's five 'thrashers' (kmeans/histo/mri-gri/spmv/lbm, Fig. 1) have
    # low knees; well-coalesced streaming apps tolerate many streams.
    contention_knee: float = 72.0


# Historical name, still used across the repo via ``core.traces.Workload``
# (``repro.workloads.Workload`` is the *composed request stream*, a
# different thing — see ``workloads/tenancy.py``).
Workload = AppSpec


# Parameters per app (Table 2).  inst_per_access separates the two classes:
# the paper's compute-bound apps scale linearly to 68 SMs.
WORKLOADS: Dict[str, AppSpec] = {w.name: w for w in [
    # The nine 'saturators'.  inst_per_access is low enough that the
    # bandwidth wall arrives near ~50% of the cores (paper: performance
    # saturates at ~56% of SMs on average), and working sets sit between
    # 1x and 4x the conventional LLC so extra capacity (Fig. 2 / Morpheus
    # extended tier) actually pays off.
    AppSpec("p-bfs",   "powerlaw", 16 * MiB, 0.10, 0.55, 0.25, 6.5, True),
    AppSpec("cfd",     "streaming", 12 * MiB, 0.25, 0.35, 0.35, 7.0, True),
    AppSpec("dwt2d",   "tiles",    14 * MiB, 0.30, 0.40, 0.30, 6.0, True),
    AppSpec("stencil", "stencil",  16 * MiB, 0.20, 0.45, 0.30, 7.5, True),
    AppSpec("r-bfs",   "powerlaw", 18 * MiB, 0.10, 0.55, 0.25, 6.0, True),
    # bprob re-reads per-layer weight tiles (partial reuse, not a pure
    # cyclic sweep — keeps its 4x-LLC gain below kmeans's, per Fig. 2)
    AppSpec("bprob",   "tiles",    14 * MiB, 0.30, 0.50, 0.25, 6.5, True),
    AppSpec("sgem",    "tiles",    16 * MiB, 0.15, 0.30, 0.35, 8.5, True),
    # nw re-reads the previous anti-diagonal row each pass: a sweep whose
    # footprint is the row band (capacity-sensitive, unlike a pure
    # sliding-window wavefront)
    AppSpec("nw",      "sweep",    14 * MiB, 0.35, 0.45, 0.30, 6.0, True),
    AppSpec("page-r",  "powerlaw", 14 * MiB, 0.15, 0.50, 0.25, 5.5, True),
    # The five 'thrashers' (perf drops after some SM count, Fig. 1 bottom).
    # Skewed/irregular footprints well beyond the LLC: capacity gains are
    # graded (powerlaw/scatter tails), not all-or-nothing.
    AppSpec("kmeans",  "powerlaw", 40 * MiB, 0.05, 0.50, 0.30, 5.0,  True, contention_knee=20.0),
    AppSpec("histo",   "hotbins",  24 * MiB, 0.45, 0.60, 0.20, 5.0,  True, contention_knee=36.0),
    AppSpec("mri-gri", "scatter",  28 * MiB, 0.40, 0.35, 0.30, 6.0,  True, contention_knee=32.0),
    AppSpec("spmv",    "powerlaw", 32 * MiB, 0.05, 0.40, 0.30, 6.0,  True, contention_knee=40.0),
    AppSpec("lbm",     "powerlaw", 32 * MiB, 0.40, 0.35, 0.30, 5.0,  True, contention_knee=32.0),
    # compute-bound (Fig. 1 right)
    AppSpec("lib",     "streaming", 2 * MiB, 0.10, 0.40, 0.30, 220.0, False),
    AppSpec("hotsp",   "stencil",   3 * MiB, 0.20, 0.45, 0.30, 160.0, False),
    AppSpec("mri-q",   "streaming", 1 * MiB, 0.05, 0.40, 0.30, 300.0, False),
]}

MEMORY_BOUND = [n for n, w in WORKLOADS.items() if w.memory_bound]
COMPUTE_BOUND = [n for n, w in WORKLOADS.items() if not w.memory_bound]


def _core_stream(w: AppSpec, n: int, core: int, n_cores: int,
                 rng: np.random.Generator) -> np.ndarray:
    ws = max(w.working_set_bytes // BLOCK_BYTES, 1024)
    if w.shared_dataset:
        lo, span = 0, ws
    else:
        span = max(ws // n_cores, 256)
        lo = core * span
    phase = (core * span) // max(n_cores, 1)

    if w.pattern in ("streaming", "sweep"):
        # repeated sequential sweep; each core phase-offset into the dataset
        idx = (phase + np.arange(n)) % span
    elif w.pattern == "strided":
        stride = 17
        idx = (phase + np.arange(n) * stride) % span
    elif w.pattern == "stencil":
        base = (phase + np.arange(n)) % span
        neigh = rng.integers(-2, 3, size=n)
        row = int(np.sqrt(span)) or 1
        idx = (base + neigh * row) % span
    elif w.pattern == "tiles":
        tile = 4096  # blocks per tile, high intra-tile reuse
        tiles = max(span // tile, 1)
        t = (phase // tile + (np.arange(n) // (tile * 4))) % tiles
        idx = t * tile + rng.integers(0, tile, size=n)
    elif w.pattern == "wavefront":
        diag = (phase + np.arange(n) // 8) % span
        idx = (diag + rng.integers(0, 8, size=n)) % span
    elif w.pattern == "powerlaw":
        # Zipf-like reuse (graph frontiers, spmv columns, pagerank)
        u = rng.random(n)
        idx = (span * u ** 2.2).astype(np.int64) % span
        idx = (idx + phase) % span
    elif w.pattern == "scatter":
        idx = rng.integers(0, span, size=n)
    elif w.pattern == "hotbins":
        hot = max(span // 4, 64)   # hot histogram region straddles LLC sizes
        is_hot = rng.random(n) < 0.7
        idx = np.where(is_hot, rng.integers(0, hot, size=n),
                       (phase + np.arange(n)) % span)
    else:
        raise ValueError(w.pattern)
    return (lo + idx).astype(np.uint32)


def generate(app: str, *, n_cores: int, length: int = 200_000,
             seed: int = 0, ws_scale: float = 1.0,
             phases: Tuple[str, ...] | None = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (addrs u32, writes bool, levels i32) — round-robin interleave
    of ``n_cores`` per-core streams, ``length`` total accesses.

    ``ws_scale`` scales the working set (used with the simulator's scaled
    memory system so cache behaviour is preserved at lower cost).

    ``phases`` composes a *phase-shifting* trace: the named workloads are
    concatenated back to back in equal shares of ``length`` (``app`` is
    ignored), each phase keeping its own working set, write mix and
    compressibility — the input the online mode-split governor is built
    for (``runtime/governor.py``)."""
    if phases:
        return generate_phased(phases, n_cores=n_cores, length=length,
                               seed=seed, ws_scale=ws_scale)
    w = WORKLOADS[app]
    if ws_scale != 1.0:
        w = AppSpec(**{**w.__dict__,
                       "working_set_bytes": int(w.working_set_bytes * ws_scale)})
    # crc32, NOT hash(): Python string hashing is salted per process, so
    # hash(app) silently made every trace process-unique — the corpus
    # subsystem's cross-session bit-identical replay exposed it.  A trace
    # is now a pure function of (app, n_cores, length, seed, ws_scale).
    rng = np.random.default_rng(seed + zlib.crc32(app.encode()) % 65536)
    per_core = length // max(n_cores, 1) + 1
    streams = [_core_stream(w, per_core, c, n_cores, rng)
               for c in range(max(n_cores, 1))]
    addrs = np.stack(streams, axis=1).reshape(-1)[:length]

    writes = rng.random(length) < w.write_frac
    # compressibility is a property of the block's contents: assign a stable
    # pseudo-random level per *address* so reuse sees consistent levels
    h = (addrs.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
    u = (h % np.uint64(1000)).astype(np.float64) / 1000.0
    levels = np.where(u < w.p_high, HIGH,
                      np.where(u < w.p_high + w.p_low, LOW, UNCOMP)
                      ).astype(np.int32)
    return addrs, writes, levels


def phase_bounds(n_phases: int, length: int) -> np.ndarray:
    """End positions (exclusive) of each of ``n_phases`` equal shares of a
    ``length``-request phased trace; the last phase absorbs the remainder.
    ``searchsorted(bounds, pos, 'right')`` maps a position to its phase."""
    edges = (np.arange(1, n_phases + 1) * length) // max(n_phases, 1)
    edges[-1] = length
    return edges


def generate_phased(apps: Tuple[str, ...], *, n_cores: int,
                    length: int = 200_000, seed: int = 0,
                    ws_scale: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate per-app segments into one phase-shifting trace.

    Each phase is generated independently (its own working set and
    pattern; phase ``i`` uses ``seed + i`` so repeated apps don't replay
    byte-identical segments) and the segments are concatenated in order —
    the LLC sees an abrupt working-set change at every boundary, which is
    what the online governor must detect and adapt to."""
    apps = tuple(apps)
    assert apps, "phased trace needs at least one app"
    bounds = phase_bounds(len(apps), length)
    a_parts, w_parts, l_parts = [], [], []
    lo = 0
    for i, app in enumerate(apps):
        n = int(bounds[i]) - lo
        lo = int(bounds[i])
        if n <= 0:
            continue
        a, w, l = generate(app, n_cores=n_cores, length=n, seed=seed + i,
                           ws_scale=ws_scale)
        a_parts.append(a)
        w_parts.append(w)
        l_parts.append(l)
    return (np.concatenate(a_parts), np.concatenate(w_parts),
            np.concatenate(l_parts))


def instructions_for(app: str, n_accesses: int) -> float:
    return WORKLOADS[app].inst_per_access * n_accesses
