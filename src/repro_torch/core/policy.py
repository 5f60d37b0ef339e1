"""Compute/cache mode-partition policy (paper Table 3), after
``repro.core.policy``.

Offline, per application, the number of compute-mode cores that
minimises execution time; the rest go to cache mode (at most 75% of the
cores, §4.1.3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from . import cache_sim as cs
from . import traces as tr


@dataclass(frozen=True)
class ModeSplit:
    app: str
    system: str
    n_compute: int
    n_cache: int
    exec_time_s: float


DEFAULT_GRID: Sequence[int] = (10, 14, 18, 24, 32, 40, 48, 56, 62, 68)


def grid_points(app: str, system: str, *, grid: Sequence[int],
                length: int, seed: int = 0,
                overrides: Sequence[tuple] = ()) -> List[cs.RunPoint]:
    """The sweep points of one (app, system): each compute-core count in
    the grid, cache mode getting the rest (Morpheus) or power-gating
    (IBL).  Entries whose Morpheus cache side would be empty are dropped."""
    spec = cs.SYSTEMS[system]
    w = tr.WORKLOADS[app]
    ov = tuple(sorted(tuple(o) for o in overrides))
    pts = []
    for n_compute in grid:
        n_cache = 0
        if spec.morpheus and w.memory_bound:
            n_cache = min(cs.TOTAL_CORES - n_compute,
                          int(cs.TOTAL_CORES * cs.MAX_CACHE_FRAC))
            if n_cache <= 0:
                continue
        pts.append(cs.RunPoint(app, system, n_compute, n_cache, length,
                               seed, ov))
    return pts


def sweep(points: Sequence[cs.RunPoint], device=None
          ) -> Dict[tuple, ModeSplit]:
    """Run sweep points through ``cs.run_batch`` and reduce to the
    fastest split per (app, system)."""
    best: Dict[tuple, ModeSplit] = {}
    for pt, r in zip(points, cs.run_batch(points, device)):
        key = (pt.app, pt.system)
        if key not in best or r.exec_time_s < best[key].exec_time_s:
            best[key] = ModeSplit(pt.app, pt.system, r.n_compute, r.n_cache,
                                  r.exec_time_s)
    return best


def best_split(app: str, system: str, *, grid: Sequence[int] = DEFAULT_GRID,
               length: int = 60_000, seed: int = 0,
               device=None) -> ModeSplit:
    """Sweep compute-core counts for one (app, system)."""
    pts = grid_points(app, system, grid=grid, length=length, seed=seed)
    if not pts:
        raise ValueError(f"empty sweep grid for {app}/{system}")
    return sweep(pts, device)[(app, system)]


def table3(systems: Sequence[str] = ("IBL", "Morpheus-Basic", "Morpheus-ALL"),
           apps: Sequence[str] | None = None, *, length: int = 120_000,
           device=None) -> Dict[str, Dict[str, ModeSplit]]:
    """Paper Table 3: per-app compute-core counts for each system; all
    (system, app, grid) points go through one ``run_batch``."""
    apps = list(apps or (tr.MEMORY_BOUND + tr.COMPUTE_BOUND))
    pts: List[cs.RunPoint] = []
    for system in systems:
        for app in apps:
            pts.extend(grid_points(app, system, grid=DEFAULT_GRID,
                                   length=length))
    best = sweep(pts, device)
    return {system: {app: best[(app, system)] for app in apps}
            for system in systems}
