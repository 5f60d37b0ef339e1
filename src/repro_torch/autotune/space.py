"""Typed design-space declarations for the autotuner, after
``repro.autotune.space`` (numpy only, copied and held identical).

A ``SearchSpace`` is an ordered tuple of ``Knob``s, each declaring a
finite, ordered value list.  Everything downstream — sampling, neighbour
moves, mutation/crossover, trajectory serialization — works on *index
vectors* into those lists, which keeps three properties the tuner leans
on:

  * **determinism**: a config is canonically encoded as its index tuple,
    so trajectories serialize identically across processes (no dict
    ordering, no float-repr drift on knob values);
  * **neighbourhoods**: ordered values give every knob a +/-1 step, so
    hill climbing walks the same ladders the governor does;
  * **enumerability**: spaces stay small enough to exhaust, which is how
    the benchmarks compute true regret (distance from the global best).

Decoders at the bottom map sampled configs onto the two evaluation
targets: hardware design points (``RunPoint`` with config-field
``overrides`` — ext ways, compression, predictor — through
``policy.grid_points``) and governor hyperparameters
(``GovernorConfig`` via ``runtime.governor.gcfg_from_dict``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

Config = Dict[str, object]
Key = Tuple[int, ...]


@dataclass(frozen=True)
class Knob:
    """One named dimension: a finite, *ordered* list of values."""
    name: str
    values: Tuple

    def __post_init__(self):
        assert len(self.values) >= 1, f"knob {self.name!r} has no values"
        assert len(set(self.values)) == len(self.values), \
            f"knob {self.name!r} has duplicate values"


class SearchSpace:
    """An ordered set of knobs with deterministic sampling and moves.

    All randomness comes in through the caller's ``np.random.Generator``
    — the space itself holds no RNG state, so two agents seeded alike
    walk identical paths.
    """

    def __init__(self, knobs: Sequence[Knob]):
        self.knobs: Tuple[Knob, ...] = tuple(knobs)
        names = [k.name for k in self.knobs]
        assert len(set(names)) == len(names), f"duplicate knobs: {names}"
        self.names: Tuple[str, ...] = tuple(names)

    @property
    def size(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.values)
        return n

    # ---------------------------------------------------- encode/decode
    def encode(self, config: Config) -> Key:
        """Canonical hashable key: the per-knob value indices."""
        return tuple(k.values.index(config[k.name]) for k in self.knobs)

    def decode(self, key: Sequence[int]) -> Config:
        assert len(key) == len(self.knobs), f"bad key {key!r}"
        return {k.name: k.values[i] for k, i in zip(self.knobs, key)}

    def enumerate(self) -> List[Config]:
        """Every config in the space, in lexicographic index order."""
        return [self.decode(key) for key in itertools.product(
            *(range(len(k.values)) for k in self.knobs))]

    # ---------------------------------------------------------- sampling
    def sample(self, rng: np.random.Generator) -> Config:
        return self.decode([int(rng.integers(len(k.values)))
                            for k in self.knobs])

    def neighbors(self, config: Config) -> List[Config]:
        """All single-knob +/-1 index moves (the hill-climb frontier)."""
        key = self.encode(config)
        out = []
        for d, k in enumerate(self.knobs):
            for step in (-1, 1):
                i = key[d] + step
                if 0 <= i < len(k.values):
                    out.append(self.decode(key[:d] + (i,) + key[d + 1:]))
        return out

    def mutate(self, config: Config, rng: np.random.Generator,
               p: float = 0.3) -> Config:
        """Each knob re-sampled with probability ``p`` (>=1 forced knob,
        so a mutation is never the identity on spaces with >1 value)."""
        key = list(self.encode(config))
        dims = [d for d in range(len(key)) if len(self.knobs[d].values) > 1]
        flips = [d for d in dims if rng.random() < p]
        if not flips and dims:
            flips = [int(dims[int(rng.integers(len(dims)))])]
        for d in flips:
            choices = [i for i in range(len(self.knobs[d].values))
                       if i != key[d]]
            key[d] = int(choices[int(rng.integers(len(choices)))])
        return self.decode(key)

    def crossover(self, a: Config, b: Config,
                  rng: np.random.Generator) -> Config:
        """Uniform crossover on index vectors."""
        ka, kb = self.encode(a), self.encode(b)
        return self.decode([ka[d] if rng.random() < 0.5 else kb[d]
                            for d in range(len(ka))])

    # ------------------------------------------------------ description
    def describe(self) -> List[list]:
        """JSON-ready schema (trajectory headers, docs, the verify CLI).

        An ordered ``[[name, values], ...]`` list, NOT a dict: knob
        order is part of the sampling stream, and ``json.dumps(...,
        sort_keys=True)`` must not be able to reorder it."""
        return [[k.name, list(k.values)] for k in self.knobs]

    @classmethod
    def from_description(cls, desc: Sequence[Sequence]) -> "SearchSpace":
        """Rebuild a space from ``describe()`` output (trajectory replay).

        JSON round-trips tuples to lists; knob values are scalars
        (int/float/str/bool) so the rebuild is exact."""
        return cls([Knob(name, tuple(values)) for name, values in desc])


# ---------------------------------------------------------------- spaces

def hw_space(*, splits: Sequence[int] = (18, 32, 40, 48, 56),
             ext_ways: Sequence[int] = (16, 32, 64),
             predictors: Sequence[str] = ("bloom",)) -> SearchSpace:
    """The hardware design space around the paper's Table-3 region.

    ``n_compute`` spans the serving ladder (cache mode gets the rest,
    exactly ``policy.grid_points``'s split rule); ``ext_ways`` brackets
    the paper's 32-way extended sets (budget = ways x 128 B per set);
    ``compression`` toggles §4.3.1 BDI.  ``predictors`` defaults to the
    paper design only — pass ``("bloom", "perfect")`` to let the search
    also find the oracle ablation (std/full profiles).
    """
    knobs = [Knob("n_compute", tuple(int(s) for s in splits)),
             Knob("ext_ways", tuple(int(w) for w in ext_ways)),
             Knob("compression", (False, True))]
    if len(predictors) > 1:
        knobs.append(Knob("predictor", tuple(predictors)))
    return SearchSpace(knobs)


def gov_space() -> SearchSpace:
    """The governor-hyperparameter space around ``SERVING_GCFG``.

    Knobs cover the axes the serving governor was hand-tuned on against
    split thrashing: switching inertia (hysteresis, min_gain),
    exploration (epsilon), estimate smoothing (ema_down) and phase-reset
    sensitivity (phase_threshold, signature_threshold).  Every ``SERVING_GCFG``
    value is a member, so "meet or beat the hand-tuned preset" is always
    reachable and the benchmark gate is honest.
    """
    return SearchSpace([
        Knob("hysteresis", (1, 2, 3, 4)),
        Knob("min_gain", (0.03, 0.08, 0.15)),
        Knob("epsilon", (0.05, 0.15, 0.3)),
        Knob("ema_down", (0.25, 0.5, 1.0)),
        Knob("phase_threshold", (0.3, 0.5, 0.8)),
        Knob("signature_threshold", (0.15, 0.35, 0.6)),
    ])


# -------------------------------------------------------------- decoders

def to_run_points(config: Config, *, app: str, system: str, length: int,
                  seed: int = 0):
    """Decode a hw-space config to its ``RunPoint``s (usually one).

    ``n_compute`` goes through ``policy.grid_points`` (which owns the
    split rule and drops infeasible cache sides); every other knob
    becomes a ``MorpheusConfig`` override carried on the point (the
    device is an argument of ``cache_sim.run_batch``, not of the point).
    """
    from ..core import policy
    overrides = tuple(sorted((k, v) for k, v in config.items()
                             if k != "n_compute"))
    return policy.grid_points(app, system, grid=[config["n_compute"]],
                              length=length, seed=seed,
                              overrides=overrides)


def to_gcfg(config: Config, base=None):
    """Decode a gov-space config to a ``GovernorConfig`` over ``base``
    (default: the hand-tuned ``SERVING_GCFG`` — the search varies only
    its declared knobs)."""
    from ..runtime.governor import SERVING_GCFG, gcfg_from_dict
    return gcfg_from_dict(config, base if base is not None
                          else SERVING_GCFG)
