"""Evaluation targets — score a whole generation as ONE batched dispatch,
after ``repro.autotune.objectives``.

The objective protocol the ``Tuner`` drives:

  * ``evaluate(configs)`` -> one score per config, higher = better,
    computed for the WHOLE generation in one batched call;
  * ``dispatches`` counts those batched calls — the tests assert it
    equals the generation count, which is the autotuner's whole
    performance story (a population is one sweep, not K runs);
  * ``describe()`` -> JSON-ready provenance for trajectory headers.

Scores are plain floats from the deterministic simulator, so a given
(objective, config) pair always scores identically — the trajectory
replay guarantee rests on this.

``HardwareObjective`` decodes configs to ``RunPoint``s (mode split +
``MorpheusConfig`` overrides) and sweeps them through
``cache_sim.run_batch``; duplicate design points within a generation
(agents do re-propose) are deduplicated before the sweep and fanned back
out.  ``GovernorObjective`` decodes configs to ``GovernorConfig``s and
scores each on the bursty serving corpus via
``runtime.fleet.evaluate_governors`` — one fleet run per generation, the
fig_serving convergence-ratio metric (governed IPC / best static IPC,
mean over cells) as the score.

Both run through the port's engine on ``device`` (None: the CUDA card;
``"cpu"``: the plain versions) where the reference takes ``backend``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import cache_sim as cs
from . import space as sp


class HardwareObjective:
    """IPC of a design point (split x ext ways x compression x predictor)
    on one app — the Table-3 rediscovery target."""

    name = "hw"

    def __init__(self, app: str, *, system: str = "Morpheus-ALL",
                 length: int = 30_000, seed: int = 0, device=None):
        self.app = app
        self.system = system
        self.length = int(length)
        self.seed = int(seed)
        self.device = device
        self.dispatches = 0

    def _points(self, config: sp.Config) -> List[cs.RunPoint]:
        return sp.to_run_points(config, app=self.app, system=self.system,
                                length=self.length, seed=self.seed)

    def evaluate(self, configs: Sequence[sp.Config]) -> List[float]:
        pts: List[Optional[cs.RunPoint]] = []
        for c in configs:
            decoded = self._points(c)
            # infeasible (cache side empty): score -inf, don't dispatch
            pts.append(decoded[0] if decoded else None)
        unique: Dict[cs.RunPoint, int] = {}
        for p in pts:
            if p is not None and p not in unique:
                unique[p] = len(unique)
        results = cs.run_batch(list(unique), self.device) if unique else []
        self.dispatches += 1 if unique else 0
        return [float(results[unique[p]].ipc) if p is not None
                else float("-inf") for p in pts]

    def exhaustive(self, space: sp.SearchSpace) -> Dict[sp.Key, float]:
        """Ground truth: every config in the space, one sweep.  The
        benchmarks use this for true regret; it does NOT count against
        ``dispatches`` (it is the thing the search avoids needing)."""
        configs = space.enumerate()
        saved = self.dispatches
        scores = self.evaluate(configs)
        self.dispatches = saved
        return {space.encode(c): s for c, s in zip(configs, scores)}

    def describe(self) -> Dict:
        return {"objective": self.name, "app": self.app,
                "system": self.system, "length": self.length,
                "seed": self.seed}


class GovernorObjective:
    """fig_serving convergence ratio of a governor config on the bursty
    multi-tenant corpus — the ``SERVING_GCFG``-replacement target.

    ``cells`` are (mix, arrival-spec) pairs; each is composed once via
    ``workloads.bursty_workload`` and its best-static IPC swept once
    (one fleet run of fixed-split replicas over the ladder) — both
    cached across generations, so a generation's marginal cost is
    exactly one ``evaluate_governors`` fleet run of K x M replicas.
    """

    name = "gov"

    def __init__(self, cells: Sequence[Tuple[str, str]], *,
                 system: str = "Morpheus-ALL", length: int = 60_000,
                 n_cores: int = 32, target_epoch: int = 3_000,
                 ladder_grid: Sequence[int] = (18, 32, 48, 68),
                 seed: int = 0, device=None):
        from ..runtime.governor import candidates_for
        from ..workloads.serving import bursty_workload
        self.cells = [(mix, arr) for mix, arr in cells]
        self.system = system
        self.length = int(length)
        self.target_epoch = int(target_epoch)
        self.seed = int(seed)
        self.device = device
        self.workloads = [bursty_workload(mix, arr, length=self.length,
                                          n_cores=n_cores, seed=self.seed)
                          for mix, arr in self.cells]
        self.ladders = [candidates_for(wl.primary_app, system,
                                       grid=tuple(ladder_grid),
                                       length=self.length)
                        for wl in self.workloads]
        self._best_static: Optional[List[float]] = None
        self.dispatches = 0

    def best_static_ipcs(self) -> List[float]:
        """Per-cell best fixed-split IPC (the ratio denominator), swept
        once as one fleet run of all (cell, rung) replicas."""
        if self._best_static is None:
            from ..runtime.fleet import ReplicaSpec, simulate_fleet
            specs = [ReplicaSpec(wl, self.system,
                                 target_epoch=self.target_epoch,
                                 fixed_split=s, name=f"c{m}/s{s[0]}")
                     for m, wl in enumerate(self.workloads)
                     for s in self.ladders[m]]
            fr = simulate_fleet(specs, device=self.device)
            best, i = [], 0
            for m in range(len(self.workloads)):
                n = len(self.ladders[m])
                best.append(max(r.ipc for r in fr.results[i:i + n]))
                i += n
            self._best_static = best
        return self._best_static

    def score_gcfgs(self, gcfgs) -> List[float]:
        """Mean-over-cells convergence ratio for already-built configs
        (also how the benchmark scores the hand-tuned baseline)."""
        from ..runtime.fleet import evaluate_governors
        best = self.best_static_ipcs()
        results = evaluate_governors(self.workloads, gcfgs,
                                     system=self.system,
                                     candidates=self.ladders,
                                     target_epoch=self.target_epoch,
                                     device=self.device)
        self.dispatches += 1
        return [float(np.mean([r.ipc / b for r, b in zip(row, best)]))
                for row in results]

    def evaluate(self, configs: Sequence[sp.Config]) -> List[float]:
        return self.score_gcfgs([sp.to_gcfg(c) for c in configs])

    def describe(self) -> Dict:
        return {"objective": self.name, "cells": self.cells,
                "system": self.system, "length": self.length,
                "target_epoch": self.target_epoch, "seed": self.seed}
