"""Search agents — pluggable proposal strategies over a ``SearchSpace``.

After ``repro.autotune.agents`` (numpy only, copied and held identical).

The agent protocol is deliberately minimal (ArchGym-style) so new
strategies — Bayesian optimization, successive halving — can land
without touching the tuner:

  * ``propose()``  -> the next generation: a list of ``pop`` configs.
    The tuner evaluates ALL of them as one batched dispatch, so an
    agent's generation size is its parallelism, not its cost model.
  * ``observe(configs, scores)`` -> feedback for exactly the proposed
    generation (higher score = better).

Determinism contract: an agent's only randomness is its own
``np.random.default_rng(seed)``, and ``propose`` must be a pure function
of (seed, history of observed scores).  The tuner's resume path replays
``propose``/``observe`` against the logged trajectory and asserts the
proposals match — an agent that breaks the contract fails loudly there
rather than silently forking the search.

Every agent tracks ``best`` / ``best_score`` from observations only
(never from its internal intent), so the trajectory's best-so-far curve
is exactly the regret curve the benchmarks plot.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .space import Config, Key, SearchSpace


class SearchAgent:
    """Shared bookkeeping: seeded RNG + best-observed tracking."""

    name = "base"

    def __init__(self, space: SearchSpace, *, seed: int = 0, pop: int = 8):
        assert pop >= 1
        self.space = space
        self.seed = int(seed)
        self.pop = int(pop)
        self.rng = np.random.default_rng(self.seed)
        self.best: Optional[Config] = None
        self.best_score = -np.inf
        self.generation = 0
        self.scores: Dict[Key, float] = {}   # every (config, score) seen

    # -- protocol ----------------------------------------------------
    def propose(self) -> List[Config]:
        raise NotImplementedError

    def observe(self, configs: Sequence[Config],
                scores: Sequence[float]) -> None:
        assert len(configs) == len(scores)
        for c, s in zip(configs, scores):
            s = float(s)
            self.scores[self.space.encode(c)] = s
            if s > self.best_score:
                self.best, self.best_score = dict(c), s
        self.generation += 1
        self._after_observe(list(configs), [float(s) for s in scores])

    def _after_observe(self, configs: List[Config],
                       scores: List[float]) -> None:
        pass

    # -- helpers -----------------------------------------------------
    def _fill_random(self, batch: List[Config], n: int) -> List[Config]:
        """Top a generation up to ``n`` with fresh random samples,
        avoiding duplicates within the generation when possible."""
        seen = {self.space.encode(c) for c in batch}
        tries = 0
        while len(batch) < n:
            c = self.space.sample(self.rng)
            k = self.space.encode(c)
            tries += 1
            if k in seen and tries < 20 * n:
                continue
            seen.add(k)
            batch.append(c)
        return batch


class RandomWalk(SearchAgent):
    """Pure random sampling — the regret baseline every structured agent
    must beat (and the only agent immune to landscape pathologies)."""

    name = "random"

    def propose(self) -> List[Config]:
        return self._fill_random([], self.pop)


class HillClimb(SearchAgent):
    """Greedy neighbourhood descent with random restarts.

    Each generation proposes the unvisited +/-1 neighbours of the best
    config observed so far (the whole frontier is one batched dispatch),
    topped up with random samples.  When every neighbour has been
    visited and none improved for ``patience`` generations, the climb
    restarts from a fresh random point — but keeps the global best, so
    regret is monotone.
    """

    name = "hill"

    def __init__(self, space: SearchSpace, *, seed: int = 0, pop: int = 8,
                 patience: int = 2):
        super().__init__(space, seed=seed, pop=pop)
        self.patience = int(patience)
        self.anchor: Optional[Config] = None     # current climb position
        self.anchor_score = -np.inf
        self.stall = 0

    def propose(self) -> List[Config]:
        if self.anchor is None:
            return self._fill_random([], self.pop)
        batch = [c for c in self.space.neighbors(self.anchor)
                 if self.space.encode(c) not in self.scores]
        batch = batch[:self.pop]
        return self._fill_random(batch, self.pop)

    def _after_observe(self, configs, scores) -> None:
        gen_best = int(np.argmax(scores))
        if scores[gen_best] > self.anchor_score or self.anchor is None:
            self.anchor = dict(configs[gen_best])
            self.anchor_score = scores[gen_best]
            self.stall = 0
        else:
            self.stall += 1
            if self.stall > self.patience:
                self.anchor, self.anchor_score = None, -np.inf
                self.stall = 0


class Genetic(SearchAgent):
    """A small steady-state GA: elites survive, the rest of each
    generation is crossover of fitness-ranked parents plus mutation."""

    name = "ga"

    def __init__(self, space: SearchSpace, *, seed: int = 0, pop: int = 8,
                 elite: int = 2, mutate_p: float = 0.3):
        super().__init__(space, seed=seed, pop=pop)
        self.elite = max(1, min(int(elite), self.pop - 1)) \
            if self.pop > 1 else 0
        self.mutate_p = float(mutate_p)
        self.parents: List[Tuple[Config, float]] = []

    def propose(self) -> List[Config]:
        if not self.parents:
            return self._fill_random([], self.pop)
        ranked = sorted(self.parents, key=lambda cs: -cs[1])
        batch = [dict(c) for c, _ in ranked[:self.elite]]
        # rank-weighted parent choice: linear weights over sorted fitness
        w = np.arange(len(ranked), 0, -1, dtype=float)
        w /= w.sum()
        while len(batch) < self.pop:
            i, j = self.rng.choice(len(ranked), size=2, p=w)
            child = self.space.crossover(ranked[int(i)][0],
                                         ranked[int(j)][0], self.rng)
            child = self.space.mutate(child, self.rng, self.mutate_p)
            batch.append(child)
        return batch

    def _after_observe(self, configs, scores) -> None:
        merged = {self.space.encode(c): (dict(c), s)
                  for c, s in self.parents}
        for c, s in zip(configs, scores):
            k = self.space.encode(c)
            if k not in merged or s > merged[k][1]:
                merged[k] = (dict(c), s)
        ranked = sorted(merged.values(), key=lambda cs: -cs[1])
        self.parents = ranked[:max(self.pop, 2 * self.elite)]


AGENTS = {a.name: a for a in (RandomWalk, HillClimb, Genetic)}


def make_agent(name: str, space: SearchSpace, *, seed: int = 0,
               pop: int = 8, **kw) -> SearchAgent:
    """Agent factory — ``name`` is one of ``AGENTS`` (benchmarks and the
    trajectory CLI rebuild agents from their logged name)."""
    if name not in AGENTS:
        raise ValueError(f"unknown agent {name!r} "
                         f"(available: {sorted(AGENTS)})")
    return AGENTS[name](space, seed=seed, pop=pop, **kw)
