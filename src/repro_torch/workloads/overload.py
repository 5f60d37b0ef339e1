"""Seeded overload scenarios: the load shapes the QoS layer is graded on
(a copy of ``repro.workloads.overload``).

One ``LoadScenario`` describes how offered load evolves over a run as a
multiplier of a base round size: a ``step`` up to the peak, periodic
``spike`` bursts, or ``sustained`` peak pressure.  The 2-10x peak range
is the regime ``benchmarks/fig_overload.py`` sweeps for its
graceful-degradation curves, and tests/test_overload.py replays the
same canonical instances (``SCENARIOS``) against pinned admission-event
goldens — the fixture library and the benchmark share one definition,
so a shape change fails the pinned tests before it skews a figure.

Everything here is pure arithmetic on (shape, peak, rounds, seed):
``demand_schedule`` apportions each round's total across tenants by
their SLO weights with the same largest-remainder rule the budgeter
uses, so a schedule is reproducible from its scenario alone — no RNG
state, no wall clock.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence

from .serving import TenantSLO, apportion_largest_remainder

SHAPES = ("step", "spike", "sustained")


@dataclass(frozen=True)
class LoadScenario:
    """A deterministic offered-load trajectory.

    ``peak`` is the overload multiplier (2.0 = 2x the base round size);
    ``shape`` decides when it applies:

      step       1x for the first third of the run, then peak
      spike      1x baseline with width-2 peak bursts every 6 rounds
                 (starting at round 3)
      sustained  peak from round 0 — the worst case fig_overload sweeps
    """
    name: str
    shape: str
    peak: float
    rounds: int
    seed: int = 0

    def __post_init__(self):
        assert self.shape in SHAPES, \
            f"unknown load shape {self.shape!r} (known: {SHAPES})"
        assert self.peak >= 1.0 and self.rounds >= 1

    def multipliers(self) -> List[float]:
        """Per-round load multiplier, length ``rounds``."""
        if self.shape == "sustained":
            return [self.peak] * self.rounds
        if self.shape == "step":
            knee = max(self.rounds // 3, 1)
            return [1.0 if r < knee else self.peak
                    for r in range(self.rounds)]
        # spike: width-2 bursts every 6 rounds, first at round 3
        out = []
        for r in range(self.rounds):
            burst = r >= 3 and (r - 3) % 6 in (0, 1)
            out.append(self.peak if burst else 1.0)
        return out


def demand_schedule(scn: LoadScenario, tenants: Sequence[TenantSLO],
                    base_total: int) -> List[Dict[str, int]]:
    """Offered requests per tenant per round.

    Each round's total = ``round(base_total * multiplier)``, split
    across tenants by SLO weight under largest-remainder apportionment —
    integer-exact (the round totals are conserved) and deterministic, so
    the schedule is pinnable in goldens."""
    assert base_total >= 1 and tenants
    weights = [t.weight for t in tenants]
    names = [t.name for t in tenants]
    out = []
    for m in scn.multipliers():
        shares = apportion_largest_remainder(weights,
                                             int(round(base_total * m)))
        out.append(dict(zip(names, shares)))
    return out


def offered_totals(schedule: Sequence[Mapping[str, int]]
                   ) -> Dict[str, int]:
    """Total offered requests per tenant over a schedule."""
    names = list(schedule[0]) if schedule else []
    return {n: sum(int(r.get(n, 0)) for r in schedule) for n in names}


# Canonical instances: what tests/test_overload.py pins goldens against
# and what fig_overload's --quick mode replays (at varying peaks).
SCENARIOS: Dict[str, LoadScenario] = {
    "step4": LoadScenario("step4", "step", 4.0, rounds=18, seed=11),
    "spike6": LoadScenario("spike6", "spike", 6.0, rounds=18, seed=12),
    "sustained2": LoadScenario("sustained2", "sustained", 2.0,
                               rounds=14, seed=13),
    "sustained8": LoadScenario("sustained8", "sustained", 8.0,
                               rounds=14, seed=14),
}
