"""Request arrival processes: timestamping and time-window epoching (a
numpy-only copy of ``repro.workloads.arrivals``).

A trace source says *what* the LLC request stream looks like; an arrival
process says *when* each request arrives.  Timestamps are what turn a
clean back-to-back replay into the contended, bursty load the online
governor has to survive: a time-windowed epoch under a bursty process
holds wildly varying request counts, so the governor's per-epoch reward
is noisy exactly the way CABA-style phase scheduling observes.

Three processes (all rates in requests/second, host-side numpy, fully
deterministic under a fixed seed):

  * ``Deterministic(rate)``       — evenly spaced arrivals (CV = 0);
  * ``Poisson(rate)``             — exponential inter-arrival gaps
                                    (CV = 1, memoryless);
  * ``MMPP(rate_a, rate_b, mean_sojourn_a, mean_sojourn_b)`` — two-state
    Markov-modulated Poisson process: the process sojourns in state A/B
    for exponentially distributed durations, emitting Poisson arrivals at
    that state's rate (CV > 1, bursty).  ``rate_a = 0`` gives the classic
    on-off process (silence, then a burst).

Spec strings (CLI / benchmark knobs; ``make_arrival``):

  "det:2e6"                   Deterministic(2e6)
  "poisson:2e6"               Poisson(2e6)
  "mmpp:5e5,8e6,2e-3,5e-4"    MMPP(rate_a, rate_b, sojourn_a, sojourn_b)
  "onoff:8e6,1e-3,3e-3"       MMPP(0, rate, on_sojourn=1e-3, off=3e-3)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


class ArrivalProcess:
    """Base: subclasses implement ``timestamps(n, seed)`` -> monotone
    nondecreasing float64 seconds, length n, deterministic per seed."""

    def timestamps(self, n: int, seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    def mean_rate(self) -> float:
        """Long-run arrivals/second (used to size time windows)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Deterministic(ArrivalProcess):
    rate: float

    def __post_init__(self):
        assert self.rate > 0, "arrival rate must be positive"

    def timestamps(self, n: int, seed: int = 0) -> np.ndarray:
        return np.arange(n, dtype=np.float64) / self.rate

    def mean_rate(self) -> float:
        return self.rate


@dataclass(frozen=True)
class Poisson(ArrivalProcess):
    rate: float

    def __post_init__(self):
        assert self.rate > 0, "arrival rate must be positive"

    def timestamps(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / self.rate, size=n)
        ts = np.cumsum(gaps)
        ts[0] = 0.0          # first request arrives at t=0 (like det)
        return ts

    def mean_rate(self) -> float:
        return self.rate


@dataclass(frozen=True)
class MMPP(ArrivalProcess):
    """Two-state Markov-modulated Poisson process (on-off when rate_a=0)."""
    rate_a: float
    rate_b: float
    mean_sojourn_a: float      # seconds in state A per visit (exp. mean)
    mean_sojourn_b: float

    def __post_init__(self):
        assert self.rate_a >= 0 and self.rate_b > 0
        assert self.mean_sojourn_a > 0 and self.mean_sojourn_b > 0

    def timestamps(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty(n, np.float64)
        got = 0
        t = 0.0
        state_b = True          # start in the busy state: t=0 sees traffic
        while got < n:
            rate = self.rate_b if state_b else self.rate_a
            sojourn = rng.exponential(
                self.mean_sojourn_b if state_b else self.mean_sojourn_a)
            if rate > 0:
                # expected arrivals this sojourn + slack; trim to sojourn
                k = max(int(rate * sojourn * 1.5) + 8, 8)
                gaps = rng.exponential(1.0 / rate, size=k)
                ts = t + np.cumsum(gaps)
                ts = ts[ts < t + sojourn][: n - got]
                out[got:got + len(ts)] = ts
                got += len(ts)
            t += sojourn
            state_b = not state_b
        if n:
            out -= out[0]        # normalize: first arrival at t=0
        return out

    def mean_rate(self) -> float:
        ta, tb = self.mean_sojourn_a, self.mean_sojourn_b
        return (self.rate_a * ta + self.rate_b * tb) / (ta + tb)


def make_arrival(spec: str) -> ArrivalProcess:
    """Parse an arrival spec string (see module docstring)."""
    kind, _, rest = spec.partition(":")
    kind = kind.strip().lower()
    try:
        args = [float(x) for x in rest.split(",")] if rest else []
        if kind == "det":
            (rate,) = args
            return Deterministic(rate)
        if kind == "poisson":
            (rate,) = args
            return Poisson(rate)
        if kind == "mmpp":
            ra, rb, sa, sb = args
            return MMPP(ra, rb, sa, sb)
        if kind == "onoff":
            rate, on_s, off_s = args
            return MMPP(0.0, rate, mean_sojourn_a=off_s, mean_sojourn_b=on_s)
    except (ValueError, AssertionError) as e:
        raise ValueError(f"bad arrival spec {spec!r}: {e}") from None
    raise ValueError(f"unknown arrival kind {kind!r} in {spec!r} "
                     f"(det|poisson|mmpp|onoff)")


# --------------------------------------------------------------- analysis

def empirical_rate(ts: np.ndarray) -> float:
    """Observed arrivals/second over the trace span."""
    ts = np.asarray(ts, np.float64)
    if len(ts) < 2 or ts[-1] <= ts[0]:
        return 0.0
    return (len(ts) - 1) / (ts[-1] - ts[0])


def burstiness(ts: np.ndarray) -> float:
    """Coefficient of variation of inter-arrival gaps: 0 deterministic,
    ~1 Poisson, >1 bursty (MMPP/on-off)."""
    gaps = np.diff(np.asarray(ts, np.float64))
    if len(gaps) == 0 or gaps.mean() <= 0:
        return 0.0
    return float(gaps.std() / gaps.mean())


# ---------------------------------------------------------------- epoching

def epochs_by_time(ts: np.ndarray, window_s: float,
                   min_requests: int = 1) -> List[Tuple[int, int]]:
    """Chunk a timestamped stream into wall-clock-window epochs.

    Returns [lo, hi) request-index bounds, one per non-empty window —
    under a bursty process the epochs have very different sizes, which is
    the point: the governor meters time, not requests.  Windows with
    fewer than ``min_requests`` are merged into the following epoch: an
    epoch must teach the governor something, and a near-empty off-period
    window would hand it a one-request reward sample of pure noise.
    """
    ts = np.asarray(ts, np.float64)
    n = len(ts)
    if n == 0:
        return []
    assert window_s > 0
    win = np.floor((ts - ts[0]) / window_s).astype(np.int64)
    # boundaries where the window index changes
    cuts = np.nonzero(np.diff(win))[0] + 1
    bounds: List[Tuple[int, int]] = []
    lo = 0
    for hi in list(cuts) + [n]:
        if hi - lo >= min_requests:
            bounds.append((lo, int(hi)))
            lo = int(hi)
    if lo < n:                       # tail too small: merge into the last
        if bounds:
            bounds[-1] = (bounds[-1][0], n)
        else:
            bounds.append((lo, n))
    return bounds


def epochs_by_count(n: int, epoch_len: int) -> List[Tuple[int, int]]:
    """Fixed-size request-count epochs (the classic EpochStream split)."""
    assert epoch_len > 0
    return [(lo, min(lo + epoch_len, n)) for lo in range(0, n, epoch_len)]
