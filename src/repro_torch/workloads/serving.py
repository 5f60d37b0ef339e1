"""Serving-side workload helpers: bursty round sizes + tenant prompts (a
copy of ``repro.workloads.serving``).

The trace-level composer (``tenancy``) drives the *simulator*; this
module drives the *serving engine* (``launch/serve.py`` /
``examples/serve_morpheus.py``): the ``--arrival`` knob maps an arrival
process onto per-round request counts (a round models one scheduling
window — under an on-off process some rounds are packed and some idle),
and the ``--workload`` knob names K tenant prompt families whose
requests interleave within each round, so the page pool and the
``ServingGovernor`` see contended multi-tenant traffic instead of one
repeated demo batch.

``SLOBudgeter`` is the third knob (``--slo-ms``): instead of a fixed
round size, a closed loop converts the pool's observed ns/lookup
telemetry into the next round's request budget, so each round's modeled
service time tracks a latency target (docs/qos.md).
``TenantSLOBudgeter`` generalizes it to one SLO per tenant
(``--tenant-slo``): the round envelope is the tightest active SLO and
the budget is apportioned across tenants by weight over learned
per-tenant cost (largest-remainder, conserving the round total) — the
input side of the admission controller (``runtime/admission.py``).

The helpers return plain data (counts, token lists); the launchers build
``serving.Request`` objects themselves — workloads stays below serving
in the layering.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from . import arrivals as arrlib


def round_sizes(arrival: str, rounds: int, mean_batch: int,
                seed: int = 0) -> List[int]:
    """Requests arriving in each of ``rounds`` equal scheduling windows.

    Samples ``rounds * mean_batch`` arrivals from the process and bins
    them into ``rounds`` windows spanning the whole stream: a
    deterministic process gives ``mean_batch`` per round, an on-off/MMPP
    process gives bursts and idle windows (count 0 = nothing arrived).
    """
    assert rounds > 0 and mean_batch > 0
    proc = arrlib.make_arrival(arrival)
    n = rounds * mean_batch
    ts = np.asarray(proc.timestamps(n, seed=seed), np.float64)
    span = float(ts[-1] - ts[0])
    if span <= 0:
        return [mean_batch] * rounds
    win = np.minimum(((ts - ts[0]) / span * rounds).astype(np.int64),
                     rounds - 1)
    return np.bincount(win, minlength=rounds).tolist()


def tenant_prompts(workload: str, prompt_len: int
                   ) -> List[Tuple[str, List[int]]]:
    """Per-tenant (name, prompt tokens) families for a '+/,'-joined spec.

    Each tenant gets a distinct deterministic token family, so its pages
    hash to a distinct prefix population in the pool: tenants *share* the
    cache tiers but never each other's pages — the serving analogue of
    the composer's per-tenant address-space tagging.
    """
    names = [s.strip() for s in workload.replace("+", ",").split(",")
             if s.strip()]
    assert names, f"empty workload spec {workload!r}"
    out = []
    for k, name in enumerate(names):
        tokens = [((7 + 2 * k) * j + 3 + 13 * k) % 97 + 1
                  for j in range(prompt_len)]
        out.append((name, tokens))
    return out


@dataclass
class SLOBudgeter:
    """Closed-loop round budgeter toward a latency target (docs/qos.md).

    A fixed round size serves whatever arrived regardless of how long
    the round will take; the budgeter instead admits only as many
    requests as the SLO affords.  Per round it observes the pool's
    telemetry — ns/lookup, lookups and requests served — maintains an
    EMA of the modeled *ns per request* (requests drive several pool
    lookups each, so the per-request cost is learned online, not
    assumed), and sizes the next round as ``slo_ms / ns_per_request``
    clipped to ``[min_batch, max_batch]``.

    Idle rounds (zero lookups) freeze the EMA, exactly like the serving
    governor's idle-window skip: an idle gap carries no latency signal.

    On a constant-latency stream the EMA converges geometrically to the
    true per-request cost, so the budget converges to the largest SLO-
    compliant round size (tests/test_qos.py).
    """
    slo_ms: float
    min_batch: int = 1
    max_batch: int = 64
    alpha: float = 0.5                     # EMA blend per observation
    initial_batch: Optional[int] = None    # first round (default: min)
    ns_per_request: Optional[float] = field(default=None, init=False)
    rounds_observed: int = field(default=0, init=False)
    rounds_met: int = field(default=0, init=False)   # rounds within SLO

    def __post_init__(self):
        assert self.slo_ms > 0 and 0 < self.alpha <= 1
        assert 1 <= self.min_batch <= self.max_batch

    def observe(self, ns_per_lookup: float, lookups: int,
                requests: int) -> None:
        """Feed one round's telemetry (idle rounds are a frozen no-op)."""
        if lookups <= 0 or requests <= 0:
            return
        per_req = float(ns_per_lookup) * lookups / requests
        self.ns_per_request = per_req if self.ns_per_request is None else \
            (1.0 - self.alpha) * self.ns_per_request + self.alpha * per_req
        self.rounds_observed += 1
        round_ms = float(ns_per_lookup) * lookups / 1e6
        if round_ms <= self.slo_ms:
            self.rounds_met += 1
        if obs.metrics_on():
            obs.set_gauge("slo_round_ms", round_ms)
            obs.set_gauge("slo_attainment", self.attainment())

    def attainment(self) -> float:
        """Fraction of observed rounds whose modeled service time met
        the SLO (1.0 before anything is observed: no violations yet)."""
        if self.rounds_observed == 0:
            return 1.0
        return self.rounds_met / self.rounds_observed

    def next_budget(self) -> int:
        """Request budget for the next round."""
        if self.ns_per_request is None or self.ns_per_request <= 0:
            start = self.initial_batch if self.initial_batch is not None \
                else self.min_batch
            return int(np.clip(start, self.min_batch, self.max_batch))
        fit = int(self.slo_ms * 1e6 // self.ns_per_request)
        return int(np.clip(fit, self.min_batch, self.max_batch))

    # learned state, for snapshot/restore (docs/qos.md): a resumed run
    # must not silently reset the cost EMA back to the cold-start budget
    def export_state(self) -> Dict:
        return {"ns_per_request": self.ns_per_request,
                "rounds_observed": self.rounds_observed,
                "rounds_met": self.rounds_met}

    def restore_state(self, d: Mapping) -> None:
        self.ns_per_request = d["ns_per_request"]
        self.rounds_observed = int(d["rounds_observed"])
        self.rounds_met = int(d["rounds_met"])


def apportion_largest_remainder(quotas: Sequence[float],
                                total: int) -> List[int]:
    """Non-negative integer shares of ``total`` proportional to
    ``quotas``, summing to **exactly** ``total`` (largest-remainder
    method, the same rule the multi-tenant composer uses for request
    volumes).  Floors first, then hands the leftover units to the
    largest fractional remainders; ties break by index, so the result is
    a pure function of the inputs.  All-zero quotas fall back to equal
    shares.  Conservation is property-tested (tests/test_properties.py).
    """
    q = np.asarray(list(quotas), np.float64)
    n = len(q)
    assert n > 0 and int(total) >= 0 and np.all(q >= 0) \
        and np.all(np.isfinite(q)), f"bad apportion inputs {quotas}/{total}"
    total = int(total)
    if q.sum() <= 0:
        q = np.ones(n)
    ideal = q / q.sum() * total
    out = np.floor(ideal).astype(np.int64)
    order = sorted(range(n), key=lambda i: (-(ideal[i] - out[i]), i))
    for i in order[:total - int(out.sum())]:
        out[i] += 1
    return [int(x) for x in out]


def proportional_interleave(counts: Sequence[int]) -> List[int]:
    """Deterministic proportional interleave: a sequence of indices in
    which index ``k`` appears ``counts[k]`` times, spread as evenly as
    the counts allow (tenant k's j-th slot keys at ``(j+0.5)/n_k``).
    Shared by the per-tenant round builder below and the overload
    driver's trace composer — no tenant's requests clump at the end of a
    round, so a round cut anywhere stays representative of the mix."""
    keyed = []
    for k, n in enumerate(counts):
        n = int(n)
        assert n >= 0
        keyed.extend(((j + 0.5) / n, k) for j in range(n))
    keyed.sort()
    return [k for _, k in keyed]


@dataclass(frozen=True)
class TenantSLO:
    """One tenant's service contract: a latency target for the rounds it
    participates in, a weight (its share of the round's time envelope)
    and a priority (admission order under overload — higher first).
    ``app`` optionally names the tenant's simulator trace profile for
    the overload driver (``runtime/admission.py``); the serving
    launchers ignore it."""
    name: str
    slo_ms: float
    weight: float = 1.0
    priority: int = 0
    app: str = ""

    def __post_init__(self):
        assert self.name and self.slo_ms > 0 and self.weight >= 0


class TenantSLOBudgeter:
    """Per-tenant generalization of ``SLOBudgeter`` (docs/qos.md).

    One ``slo_ms`` target per tenant.  The round's time envelope is the
    *tightest* SLO among the tenants active in the round (every tenant
    in a round shares its service time, so the round must fit the
    strictest contract), scaled by ``headroom``.  Per tenant the modeled
    ns/request is learned as an idle-frozen EMA — same blend, same
    freeze rule as the global budgeter — and the next round's budget is
    apportioned across tenants so each gets a **time slice proportional
    to its weight**: tenant k's request quota is ``w_k / c_k`` (weight
    over learned cost), integerized by ``apportion_largest_remainder``
    so the per-tenant budgets sum to the round total exactly
    (tests/test_properties.py pins conservation).

    Attainment is tracked per tenant: a round met tenant k's SLO iff the
    round's service time fit ``slo_ms[k]`` — deferred work waits outside
    the round and is scored only in the round that serves it.
    """

    def __init__(self, tenants: Sequence[TenantSLO], *,
                 min_total: int = 1, max_total: int = 64,
                 alpha: float = 0.5, initial_total: Optional[int] = None,
                 headroom: float = 1.0):
        tenants = list(tenants)
        names = [t.name for t in tenants]
        assert tenants and len(set(names)) == len(names), \
            f"tenant names must be unique and non-empty: {names}"
        assert 1 <= min_total <= max_total and 0 < alpha <= 1 \
            and 0 < headroom <= 1
        self.tenants = tenants
        self.names = names
        self.min_total = int(min_total)
        self.max_total = int(max_total)
        self.alpha = float(alpha)
        self.initial_total = initial_total
        self.headroom = float(headroom)
        self._slo = {t.name: float(t.slo_ms) for t in tenants}
        self._w = {t.name: float(t.weight) for t in tenants}
        self.ns_per_request: Dict[str, Optional[float]] = \
            {n: None for n in names}
        self.rounds_observed: Dict[str, int] = {n: 0 for n in names}
        self.rounds_met: Dict[str, int] = {n: 0 for n in names}

    def observe(self, requests: Mapping[str, int], round_ms: float,
                ns_per_request: Optional[Mapping[str, float]] = None
                ) -> None:
        """Feed one round's telemetry.

        ``requests``: served requests per tenant this round.  ``ns_per_
        request``: per-tenant measured cost when the driver can separate
        it (the overload driver's masked per-tenant Stats rows can);
        omitted, every participating tenant samples the round-mean cost
        (the serving pool's telemetry is not separable).  Idle rounds
        (no requests) freeze every EMA, as in the global budgeter."""
        total = sum(int(requests.get(n, 0)) for n in self.names)
        if total <= 0 or round_ms <= 0:
            return
        for name in self.names:
            r = int(requests.get(name, 0))
            if r <= 0:
                continue
            if ns_per_request is not None and name in ns_per_request:
                per = float(ns_per_request[name])
            else:
                per = round_ms * 1e6 / total
            old = self.ns_per_request[name]
            self.ns_per_request[name] = per if old is None else \
                (1.0 - self.alpha) * old + self.alpha * per
            self.rounds_observed[name] += 1
            if round_ms <= self._slo[name]:
                self.rounds_met[name] += 1
        if obs.metrics_on():
            obs.set_gauge("slo_round_ms", round_ms)
            for name in self.names:
                if int(requests.get(name, 0)) > 0:
                    obs.set_gauge("tenant_slo_attainment",
                                  self.attainment(name), tenant=name)

    def attainment(self, name: Optional[str] = None) -> float:
        """Fraction of tenant ``name``'s served rounds that met its SLO
        (1.0 before any observation); with no name, the worst tenant's."""
        if name is None:
            return min((self.attainment(n) for n in self.names),
                       default=1.0)
        seen = self.rounds_observed[name]
        return 1.0 if seen == 0 else self.rounds_met[name] / seen

    def round_ms(self, active: Optional[Sequence[str]] = None) -> float:
        """The round's time envelope: tightest SLO among the active
        tenants (default: all), scaled by ``headroom``."""
        names = list(active) if active is not None else self.names
        assert names and all(n in self._slo for n in names), \
            f"unknown tenants in {names}"
        return self.headroom * min(self._slo[n] for n in names)

    def next_budgets(self, active: Optional[Sequence[str]] = None
                     ) -> Dict[str, int]:
        """Per-tenant request budgets for the next round (conserving
        apportionment of the round total — see class docstring)."""
        names = [n for n in self.names
                 if active is None or n in set(active)]
        assert names, f"no known tenant active in {active}"
        env_ns = self.round_ms(names) * 1e6
        known = [self.ns_per_request[n] for n in names
                 if self.ns_per_request[n] is not None
                 and self.ns_per_request[n] > 0]
        if not known:
            # cold start: no learned cost yet -> weight-only shares of
            # the conservative initial total
            start = self.initial_total if self.initial_total is not None \
                else self.min_total
            total = int(np.clip(start, self.min_total, self.max_total))
            shares = apportion_largest_remainder(
                [self._w[n] for n in names], total)
            return dict(zip(names, shares))
        fallback = float(np.mean(known))   # unlearned tenant: mean cost
        cost = {n: (self.ns_per_request[n]
                    if self.ns_per_request[n] else fallback)
                for n in names}
        w_sum = sum(self._w[n] for n in names)
        quotas = [(self._w[n] if w_sum > 0 else 1.0) / cost[n]
                  for n in names]
        # Σ n_k c_k == env when n_k ∝ w_k/c_k: the total that fits is
        # env * Σ(w_k/c_k) / Σ w_k  (uniform shares when all weights 0)
        total = int(env_ns * sum(quotas) / (w_sum if w_sum > 0
                                            else float(len(names))))
        total = int(np.clip(total, self.min_total, self.max_total))
        return dict(zip(names,
                        apportion_largest_remainder(quotas, total)))

    # -------------------------------------------- snapshot/restore state
    def export_state(self) -> Dict:
        """JSON-clean learned state (docs/qos.md): what a resumed run
        must carry so the cost model does not reset to cold start."""
        return {"ns_per_request": dict(self.ns_per_request),
                "rounds_observed": dict(self.rounds_observed),
                "rounds_met": dict(self.rounds_met)}

    def restore_state(self, d: Mapping) -> None:
        assert set(d["ns_per_request"]) == set(self.names), \
            "state does not match this budgeter's tenant set"
        self.ns_per_request = {n: d["ns_per_request"][n]
                               for n in self.names}
        self.rounds_observed = {n: int(d["rounds_observed"][n])
                                for n in self.names}
        self.rounds_met = {n: int(d["rounds_met"][n])
                           for n in self.names}


def slo_batches(workload: str, budgeter: SLOBudgeter, prompt_len: int
                ):
    """Generator of SLO-budgeted rounds: each ``next()`` yields the next
    round's (tenant, prompt) batch, sized by ``budgeter.next_budget()``
    at yield time (tenants round-robin across rounds, so the budget is
    spread over every tenant family).  Feed the budgeter between rounds.
    """
    fams = tenant_prompts(workload, prompt_len)
    k = 0
    while True:
        batch = []
        for _ in range(budgeter.next_budget()):
            batch.append(fams[k % len(fams)])
            k += 1
        yield batch


def tenant_slo_batches(workload: str, budgeter: TenantSLOBudgeter,
                       prompt_len: int):
    """Per-tenant successor of ``slo_batches``: each ``next()`` yields
    one round's (tenant, prompt) batch sized by
    ``budgeter.next_budgets()`` at yield time — tenant k contributes
    exactly its apportioned budget, proportionally interleaved, instead
    of the global budget round-robining across families.  The budgeter's
    tenant names must be the workload spec's family names.  Feed the
    budgeter between rounds."""
    fams = dict(tenant_prompts(workload, prompt_len))
    assert set(budgeter.names) <= set(fams), \
        (f"budgeter tenants {budgeter.names} not all in workload "
         f"families {sorted(fams)}")
    while True:
        budgets = budgeter.next_budgets()
        counts = [budgets[n] for n in budgeter.names]
        yield [(budgeter.names[k], fams[budgeter.names[k]])
               for k in proportional_interleave(counts)]


def batch_mix(batch) -> dict:
    """{tenant name -> request count} of one round's (name, tokens) batch
    (shared by both serving launchers' per-round reporting)."""
    mix: dict = {}
    for name, _ in batch:
        mix[name] = mix.get(name, 0) + 1
    return mix


def round_requests(workload: str, arrival: str, rounds: int,
                   mean_batch: int, prompt_len: int, *, seed: int = 0
                   ) -> List[List[Tuple[str, List[int]]]]:
    """Fully scheduled rounds: for each round, the (tenant, prompt) of
    every arriving request (tenants round-robin within the round)."""
    fams = tenant_prompts(workload, prompt_len)
    sizes = round_sizes(arrival, rounds, mean_batch, seed=seed)
    sched = []
    k = 0
    for size in sizes:
        batch = []
        for _ in range(size):
            batch.append(fams[k % len(fams)])
            k += 1
        sched.append(batch)
    return sched


def bursty_workload(mix: str, arrival: str, *, length: int,
                    n_cores: int = 32, seed: int = 0):
    """One cell of the bursty serving corpus (the fig_serving grid).

    K tenants' traces merged by arrival time at simulator working-set
    scale — the canonical (mix, arrival) evaluation cell shared by
    ``benchmarks/fig_serving`` and the autotuner's governor objective
    (``repro.autotune.objectives``), so a searched ``GovernorConfig`` is
    scored on exactly the corpus the hand-tuned preset was judged on.
    Imports stay inside the function: this module's scheduling helpers
    are numpy-only and load without the engine (and torch).
    """
    from ..core import cache_sim as cs
    from . import tenancy
    return tenancy.make_workload(mix, length=length, n_cores=n_cores,
                                 arrival=arrival, seed=seed,
                                 ws_scale=1.0 / cs.SIM_SCALE)
