"""Governor decision provenance: one structured event per decision path
(a copy of ``repro.obs.decision``, field for field).

The governor's split changes used to leave only a ``switched`` flag in
the telemetry; a ``DecisionEvent`` records *why* — which decision path
fired, what reward estimates were consulted, the exploration rate, and
(filled in by the driver after the handoff) the flush cost the switch
paid.  ``Governor`` appends one event per fired path unconditionally:
recording is pure host-side bookkeeping that touches no RNG, so the
decision stream is bit-identical with observability on or off
(tests/test_obs.py pins this on both engine backends).

Trigger taxonomy (``TRIGGERS``):

  greedy       measured neighbour beat the current split by ``min_gain``
  explore      epsilon draw refreshed the longest-unvisited neighbour
  hint         epsilon draw probed the bottleneck-hint direction
  phase_jump   signature re-entered a remembered phase bucket; jumped to
               its remembered best split (``Governor.phase_jumps``)
  ctx_reentry  context churn re-entered a known tenant mix; the deferred
               jump to its remembered split fired in ``decide()``
  churn_reset  context changed: estimates wiped, no split change by
               itself (``Governor.churn_resets``)
  phase_shift  phase detector wiped estimates without a remembered
               bucket to jump to (reset only, no split change)

Switch events (``switched`` True) are exactly the first five; the audit
invariant — one attributed event per split change — is what
``tools/obs_report.py`` renders and tests/test_obs.py enforces.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

TRIGGERS = ("greedy", "explore", "hint", "phase_jump", "ctx_reentry",
            "churn_reset", "phase_shift")


def _split_str(s) -> str:
    if isinstance(s, (tuple, list)):
        return "(" + "|".join(str(x) for x in s) + ")"
    return str(s)


@dataclass
class DecisionEvent:
    """One governor decision: candidates are whatever the governor walks
    (mode-split tuples in the simulator, chip counts in serving)."""

    epoch: int
    trigger: str
    from_split: object
    to_split: object
    epsilon: float
    hint: int = 0
    # candidate -> reward estimate at decision time (stringified keys so
    # the event is JSON-clean regardless of candidate type)
    estimates: Dict[str, float] = field(default_factory=dict)
    flush_writebacks: int = 0     # filled by the driver after the handoff
    replica: str = ""             # filled by the driver (fleet runs)
    ctx: Optional[int] = None     # external phase context, if any
    # cache-state summary at decision time (filled by the driver from the
    # epoch's telemetry — occupancy, hit rate, fairness...).  Always-on
    # bookkeeping like the rest of the event: computed from numbers the
    # driver already holds, so it is bit-identical with obs on or off.
    summary: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        assert self.trigger in TRIGGERS, \
            f"unknown decision trigger {self.trigger!r} (known: {TRIGGERS})"

    @property
    def switched(self) -> bool:
        return self.to_split != self.from_split

    def to_dict(self) -> Dict:
        def plain(s):
            return list(s) if isinstance(s, tuple) else s
        return {"epoch": self.epoch, "trigger": self.trigger,
                "from_split": plain(self.from_split),
                "to_split": plain(self.to_split),
                "epsilon": float(self.epsilon), "hint": int(self.hint),
                "estimates": dict(self.estimates),
                "flush_writebacks": int(self.flush_writebacks),
                "replica": self.replica, "ctx": self.ctx,
                "summary": {k: float(v) for k, v in self.summary.items()}}

    def compact(self) -> str:
        """Short rendering for the telemetry ``decision`` column, e.g.
        ``hint:(32|36)->(28|40)`` or ``churn_reset``."""
        if not self.switched:
            return self.trigger
        return (f"{self.trigger}:{_split_str(self.from_split)}"
                f"->{_split_str(self.to_split)}")


ADMISSION_KINDS = ("admit", "defer", "shed", "resume")


@dataclass
class AdmissionEvent:
    """One admission-control outcome for one tenant in one round
    (docs/observability.md) — the QoS analogue of ``DecisionEvent``,
    with the same provenance contract: the controller appends one event
    per nonzero outcome unconditionally, pure host bookkeeping touching
    no RNG, so the event stream is bit-identical with obs on or off.

    Kind taxonomy (``ADMISSION_KINDS``):

      admit    fresh requests served in the round they arrived
      defer    requests the round could not afford, re-queued with aging
      shed     requests dropped — the tenant's deferred backlog was at
               ``defer_cap``, so the overflow (newest work) is refused
      resume   previously-deferred requests finally served (``age`` =
               rounds the oldest of them waited)
    """

    round: int
    kind: str
    tenant: str
    requests: int
    age: int = 0               # resume: rounds the oldest served batch
    #                            waited; defer/shed/admit: 0
    priority: int = 0          # the tenant's admission priority
    budget: int = 0            # the tenant's apportioned round budget
    pressure: float = 0.0      # round demand / round capacity
    replica: str = ""          # filled by the driver (fleet runs)

    def __post_init__(self):
        assert self.kind in ADMISSION_KINDS, \
            f"unknown admission kind {self.kind!r} (known: {ADMISSION_KINDS})"
        assert self.requests >= 0 and self.age >= 0

    def to_dict(self) -> Dict:
        return {"round": int(self.round), "kind": self.kind,
                "tenant": self.tenant, "requests": int(self.requests),
                "age": int(self.age), "priority": int(self.priority),
                "budget": int(self.budget),
                "pressure": float(self.pressure),
                "replica": self.replica}

    def compact(self) -> str:
        """Short rendering for logs/goldens, e.g. ``defer:lo:3`` or
        ``resume:lo:3+4`` (+4 = rounds waited)."""
        s = f"{self.kind}:{self.tenant}:{int(self.requests)}"
        return s + (f"+{int(self.age)}" if self.age else "")
