"""Pluggable trace sources: the ``TraceSource`` protocol + registry (a
numpy-only copy of ``repro.workloads.sources``).

A *source* produces the (addrs, writes, levels) triple the engine
replays.  Three built-in kinds, each constructible from a spec string so
benchmarks, launchers and tools share one syntax:

  "synthetic:cfd"  (or bare "cfd")   Table-2 parameterized generator
  "phased:kmeans+lib"                phase-shifting concatenation
  "corpus:results/traces/foo.npz"    file-backed recorded trace

``register_source`` lets future scenario PRs plug new kinds in (e.g. a
real GPU-profiler importer) without touching the consumers: everything
downstream — the multi-tenant composer, the epoch stream, fig_serving —
asks the registry, never a concrete class.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

import numpy as np

from . import corpus as corpuslib
from . import synthetic

TraceArrays = Tuple[np.ndarray, np.ndarray, np.ndarray]


@runtime_checkable
class TraceSource(Protocol):
    """Anything that can produce an LLC request stream.

    ``name`` labels the source in telemetry; ``app`` names the synthetic
    profile the analytical system model should assume (instructions per
    access, DRAM contention knee) — real recorded traces declare one via
    their metadata (``like``).
    """
    name: str
    app: str

    def generate(self, *, n_cores: int, length: int, seed: int = 0,
                 ws_scale: float = 1.0) -> TraceArrays:
        """(addrs u32, writes bool, levels i32), exactly ``length`` long."""
        ...


@dataclass(frozen=True)
class SyntheticSource:
    """The Table-2 parameterized generators behind the protocol."""
    app: str

    def __post_init__(self):
        if self.app not in synthetic.WORKLOADS:
            raise ValueError(f"unknown synthetic app {self.app!r}; choose "
                             f"from {sorted(synthetic.WORKLOADS)}")

    @property
    def name(self) -> str:
        return f"synthetic:{self.app}"

    def generate(self, *, n_cores: int, length: int, seed: int = 0,
                 ws_scale: float = 1.0) -> TraceArrays:
        return synthetic.generate(self.app, n_cores=n_cores, length=length,
                                  seed=seed, ws_scale=ws_scale)


@dataclass(frozen=True)
class PhasedSource:
    """Phase-shifting concatenation of synthetic apps (equal shares)."""
    apps: Tuple[str, ...]

    def __post_init__(self):
        assert self.apps, "phased source needs at least one app"
        for a in self.apps:
            if a not in synthetic.WORKLOADS:
                raise ValueError(f"unknown synthetic app {a!r}")

    @property
    def name(self) -> str:
        return "phased:" + "+".join(self.apps)

    @property
    def app(self) -> str:
        """Primary profile: the first memory-bound phase (it dominates the
        reward model's memory terms), else the first phase."""
        return next((a for a in self.apps
                     if synthetic.WORKLOADS[a].memory_bound), self.apps[0])

    def generate(self, *, n_cores: int, length: int, seed: int = 0,
                 ws_scale: float = 1.0) -> TraceArrays:
        return synthetic.generate_phased(self.apps, n_cores=n_cores,
                                         length=length, seed=seed,
                                         ws_scale=ws_scale)


@dataclass(frozen=True)
class CorpusSource:
    """Replay of a recorded ``.npz`` corpus trace (see workloads/corpus.py).

    ``generate`` ignores ``n_cores``/``ws_scale`` (the recording already
    interleaved whatever cores produced it) and tiles/truncates the
    recorded stream to ``length`` — replay is bit-identical for a given
    (path, length, offset), independent of seed.
    """
    path: str
    offset: int = 0
    _loaded: tuple = field(default=None, repr=False, compare=False)

    @property
    def name(self) -> str:
        return f"corpus:{self.path}"

    def _arrays(self):
        # load once per source instance (frozen dataclass: object.__setattr__)
        if self._loaded is None:
            addrs, writes, levels, meta = corpuslib.load_trace(self.path)
            object.__setattr__(self, "_loaded", (addrs, writes, levels, meta))
        return self._loaded

    @property
    def meta(self) -> Dict:
        return self._arrays()[3]

    @property
    def app(self) -> str:
        return self._arrays()[3].get("like", "cfd")

    def generate(self, *, n_cores: int, length: int, seed: int = 0,
                 ws_scale: float = 1.0) -> TraceArrays:
        addrs, writes, levels, _ = self._arrays()
        n = len(addrs)
        idx = (self.offset + np.arange(length)) % n
        return addrs[idx], writes[idx], levels[idx]


# ---------------------------------------------------------------- registry

SOURCE_KINDS: Dict[str, Callable[[str], TraceSource]] = {}


def register_source(kind: str, factory: Callable[[str], TraceSource]) -> None:
    """Register a source kind: ``factory(rest_of_spec) -> TraceSource``."""
    SOURCE_KINDS[kind] = factory


register_source("synthetic", lambda rest: SyntheticSource(rest))
register_source("phased",
                lambda rest: PhasedSource(tuple(rest.split("+"))))
register_source("corpus", lambda rest: CorpusSource(rest))


def make_source(spec: str | TraceSource) -> TraceSource:
    """Resolve a spec string (or pass through an existing source).

    Bare names are sugar: a known synthetic app ("cfd"), a '+'-joined app
    list ("kmeans+lib" -> phased), or an existing ``.npz`` path.
    """
    if not isinstance(spec, str):
        return spec
    kind, sep, rest = spec.partition(":")
    if sep and kind in SOURCE_KINDS:
        return SOURCE_KINDS[kind](rest)
    # bare-name sugar
    if spec in synthetic.WORKLOADS:
        return SyntheticSource(spec)
    if "+" in spec and all(a in synthetic.WORKLOADS
                           for a in spec.split("+")):
        return PhasedSource(tuple(spec.split("+")))
    if spec.endswith(".npz") and Path(spec).exists():
        return CorpusSource(spec)
    raise ValueError(
        f"cannot resolve trace source {spec!r}: not a registered kind "
        f"({sorted(SOURCE_KINDS)}), synthetic app, phased list or .npz "
        f"path")
