"""Overload-aware admission control for the QoS serving layer, after
``repro.runtime.admission``.

Under overload the per-tenant SLO budgeter
(``workloads/serving.py::TenantSLOBudgeter``) can report a round budget
smaller than the offered demand: the learned cost model says the joint
SLO set is unattainable.  ``AdmissionController`` decides, per round,
*whose* requests run anyway:

  * fresh demand is served highest-priority-first, each tenant bounded
    by its apportioned budget first, leftover capacity work-conserving;
  * what the round cannot afford is **deferred** — re-queued with an age
    counter — unless the tenant's backlog is at ``defer_cap``, in which
    case the overflow (newest work) is **shed**;
  * a deferred batch aged ``age_boost`` rounds outranks ALL fresh work,
    so no tenant starves: as long as each round serves at least one
    request, the globally-oldest batch drains first
    (starvation-freedom is property-tested in tests/test_properties.py).

Every nonzero outcome emits a closed-taxonomy ``AdmissionEvent``
(admit/defer/shed/resume — ``repro.obs.decision``) through the same
decision-provenance path as the governor's ``DecisionEvent``: recorded
unconditionally, pure host bookkeeping, no RNG — the event stream is a
pure function of (construction inputs, demand history) and is
bit-identical with observability on or off.

``simulate_overload`` is the round loop: per-tenant synthetic
traces served through the set-parallel engine with one count-masked
Stats row per tenant (exact attribution), the budgeter learning
per-tenant ns/request from the masked rows, and the admission pressure
fed into ``Governor.observe`` so split adaptation and admission stop
fighting each other.

The controller (``AdmissionConfig``, ``RoundPlan``,
``AdmissionController``) is host code copied from the reference.
``simulate_overload`` advances the K tenants' count-masked rows through
``engine.advance_packed`` on ``device`` (None: the CUDA card; ``"cpu"``:
the plain versions), one call a round, and reads the round's Stats back
once as numpy; everything after that is the reference's numpy
arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .. import obs
from ..core import cache_sim as cs
from ..core import engine
from ..core.controller import Stats
from ..obs.decision import AdmissionEvent, DecisionEvent
from ..workloads import synthetic as tr
from ..workloads.serving import (TenantSLO, TenantSLOBudgeter,
                                 proportional_interleave)
from ..workloads.tenancy import TENANT_STRIDE_BLOCKS
from . import stream as rt_stream
from .governor import (Governor, GovernorConfig, SERVING_GCFG, Split,
                       _attribute_flush, _epoch_telemetry, candidates_for)
from .telemetry import jains_index


@dataclass(frozen=True)
class AdmissionConfig:
    """Admission-control knobs (docs/qos.md).

    ``enabled=False`` keeps the controller fully inert: every request is
    admitted, nothing queues, no events are emitted and zero pressure is
    reported — the round loop's behaviour is bit-identical to running with
    no controller at all (the parity tests pin this)."""
    enabled: bool = True
    age_boost: int = 3     # deferred rounds after which a batch outranks
    #                        all fresh work (the anti-starvation rule)
    defer_cap: int = 64    # max queued requests per tenant; overflow of
    #                        NEW work is shed (the backlog keeps aging)

    def __post_init__(self):
        assert self.age_boost >= 1 and self.defer_cap >= 0


@dataclass
class RoundPlan:
    """One round's admission outcome, per tenant."""
    round: int
    admitted: Dict[str, int]     # fresh requests served this round
    resumed: Dict[str, int]      # previously-deferred requests served
    deferred: Dict[str, int]     # fresh requests re-queued with aging
    shed: Dict[str, int]         # fresh requests refused (backlog full)
    pressure: float              # effective demand / round capacity
    events: List[AdmissionEvent] = field(default_factory=list)

    def served(self) -> Dict[str, int]:
        return {n: self.admitted[n] + self.resumed[n]
                for n in self.admitted}

    @property
    def total_served(self) -> int:
        return sum(self.served().values())


class AdmissionController:
    """Deterministic per-round admission/deferral/shedding planner.

    Pure host bookkeeping over (tenant specs, config, demand history):
    no RNG, no wall clock — two controllers fed the same history produce
    byte-identical event streams, across processes.
    """

    def __init__(self, tenants: Sequence[TenantSLO],
                 cfg: AdmissionConfig = AdmissionConfig()):
        tenants = list(tenants)
        self.tenants = tenants
        self.cfg = cfg
        self.names = [t.name for t in tenants]
        assert len(set(self.names)) == len(self.names)
        self._prio = {t.name: int(t.priority) for t in tenants}
        # admission order: priority desc, construction order breaks ties
        self._order = [t.name for t in sorted(
            tenants, key=lambda t: (-int(t.priority),
                                    self.names.index(t.name)))]
        # per-tenant deferred batches, oldest first: [rounds_waited, count]
        self.queues: Dict[str, List[List[int]]] = \
            {n: [] for n in self.names}
        self.round = 0
        self.events: List[AdmissionEvent] = []
        self.counters: Dict[str, int] = \
            {"admit": 0, "defer": 0, "shed": 0, "resume": 0}
        self.last_pressure = 0.0

    def backlog(self, name: Optional[str] = None) -> int:
        """Deferred requests queued for ``name`` (or all tenants)."""
        names = [name] if name is not None else self.names
        return sum(c for n in names for _, c in self.queues[n])

    def oldest_age(self, name: str) -> int:
        """Rounds the tenant's oldest deferred batch has waited (0 if
        none queued)."""
        q = self.queues[name]
        return q[0][0] if q else 0

    def plan(self, demand: Mapping[str, int],
             budgets: Mapping[str, int]) -> RoundPlan:
        """Plan one round: who runs, who waits, who is refused.

        ``demand`` is the fresh offered requests per tenant; ``budgets``
        the budgeter's apportioned per-tenant quotas (their sum is the
        round capacity).  Unknown tenant names are ignored."""
        r = self.round
        names = self.names
        demand = {n: int(demand.get(n, 0)) for n in names}
        budgets = {n: int(budgets.get(n, 0)) for n in names}
        assert all(v >= 0 for v in demand.values()) \
            and all(v >= 0 for v in budgets.values())
        cap = sum(budgets.values())
        admitted = {n: 0 for n in names}
        resumed = {n: 0 for n in names}
        res_age = {n: 0 for n in names}
        deferred = {n: 0 for n in names}
        shed = {n: 0 for n in names}
        if not self.cfg.enabled:
            self.round += 1
            self.last_pressure = 0.0
            return RoundPlan(r, dict(demand), resumed, deferred, shed,
                             0.0, [])
        eff = {n: demand[n] + self.backlog(n) for n in names}
        pressure = sum(eff.values()) / max(cap, 1)
        left = cap

        def take_backlog(n: str, want: int) -> int:
            got = 0
            q = self.queues[n]
            while want > 0 and q:
                age, cnt = q[0]
                t = min(cnt, want)
                got += t
                want -= t
                res_age[n] = max(res_age[n], age)
                if t == cnt:
                    q.pop(0)
                else:
                    q[0][1] = cnt - t
            return got

        # pass 0 — anti-starvation: batches deferred >= age_boost rounds
        # outrank ALL fresh work; oldest first, then priority, then
        # construction order; bounded only by the round capacity
        while left > 0:
            best = None
            for i, n in enumerate(names):
                q = self.queues[n]
                if q and q[0][0] >= self.cfg.age_boost:
                    key = (q[0][0], self._prio[n], -i)
                    if best is None or key > best[0]:
                        best = (key, n)
            if best is None:
                break
            got = take_backlog(best[1], min(self.queues[best[1]][0][1],
                                            left))
            resumed[best[1]] += got
            left -= got
        # pass 1 — per-tenant budgets in priority order: the tenant's
        # young backlog first (it already waited), then fresh demand
        for n in self._order:
            quota = max(budgets[n] - resumed[n], 0)
            got = take_backlog(n, min(quota, left))
            resumed[n] += got
            left -= got
            quota -= got
            t = min(demand[n], quota, left)
            admitted[n] += t
            left -= t
        # pass 2 — work-conserving: leftover capacity ignores budgets
        for n in self._order:
            if left <= 0:
                break
            got = take_backlog(n, left)
            resumed[n] += got
            left -= got
            t = min(demand[n] - admitted[n], left)
            admitted[n] += t
            left -= t
        # defer/shed the unserved remainder of FRESH demand; the
        # existing backlog keeps its queue position (and keeps aging),
        # defer_cap gates only new deferrals, so overflow sheds the
        # NEWEST work while the oldest batches march toward age_boost
        for n in self._order:
            rest = demand[n] - admitted[n]
            if rest <= 0:
                continue
            room = max(self.cfg.defer_cap - self.backlog(n), 0)
            d = min(rest, room)
            if d:
                self.queues[n].append([0, d])
                deferred[n] = d
            if rest - d:
                shed[n] = rest - d
        for n in names:
            for b in self.queues[n]:
                b[0] += 1
        events = []
        for n in self._order:
            for kind, cnt, age in (("resume", resumed[n], res_age[n]),
                                   ("admit", admitted[n], 0),
                                   ("defer", deferred[n], 0),
                                   ("shed", shed[n], 0)):
                if cnt > 0:
                    events.append(AdmissionEvent(
                        round=r, kind=kind, tenant=n, requests=cnt,
                        age=age, priority=self._prio[n],
                        budget=budgets[n], pressure=pressure))
        for ev in events:
            self.counters[ev.kind] += ev.requests
            obs.instant("admission.event", **ev.to_dict())
        if obs.metrics_on():
            obs.set_gauge("admission_pressure", pressure)
            for ev in events:
                obs.count("admission_requests", ev.requests, kind=ev.kind)
        self.events.extend(events)
        self.round += 1
        self.last_pressure = pressure
        return RoundPlan(r, admitted, resumed, deferred, shed, pressure,
                         events)

    # -------------------------------------------- snapshot/restore state
    def export_state(self) -> Dict:
        """JSON-clean queue/counter state for ``EpochStream`` snapshots
        (docs/qos.md): a resumed run must keep aging the same backlog."""
        return {"round": self.round,
                "queues": {n: [[int(a), int(c)] for a, c in
                               self.queues[n]] for n in self.names},
                "counters": dict(self.counters),
                "last_pressure": self.last_pressure}

    def restore_state(self, d: Mapping) -> None:
        assert set(d["queues"]) == set(self.names), \
            "state does not match this controller's tenant set"
        self.round = int(d["round"])
        self.queues = {n: [[int(a), int(c)] for a, c in d["queues"][n]]
                       for n in self.names}
        self.counters = {k: int(v) for k, v in d["counters"].items()}
        self.last_pressure = float(d["last_pressure"])


# --------------------------------------------------- overload round loop

@dataclass
class OverloadResult:
    """Outcome of one ``simulate_overload`` run."""
    tenants: List[TenantSLO]
    rounds: List[Dict]                  # per-round records
    stats: Stats                        # global totals (numpy leaves)
    tenant_stats: Dict[str, Stats]      # exact per-tenant rows
    events: List[AdmissionEvent]
    decisions: List[DecisionEvent]
    attainment: Dict[str, float]        # per-tenant SLO attainment
    offered: Dict[str, int]
    served: Dict[str, int]
    shed: Dict[str, int]
    backlog: Dict[str, int]             # still deferred when the run ended
    fairness: List[float]               # per-round Jain's index

    def served_fraction(self, name: Optional[str] = None) -> float:
        names = [name] if name is not None else list(self.offered)
        off = sum(self.offered[n] for n in names)
        return sum(self.served[n] for n in names) / max(off, 1)

    def attribution_exact(self) -> bool:
        """Per-tenant integer hit/miss counters sum to the global run
        exactly (the tenancy sum-to-global invariant, under admission)."""
        for f in ("conv_hits", "conv_misses", "ext_hits",
                  "ext_true_miss"):
            tot = int(np.asarray(getattr(self.stats, f)))
            per = sum(int(np.asarray(getattr(s, f)))
                      for s in self.tenant_stats.values())
            if tot != per:
                return False
        return True

    def summary(self) -> Dict:
        return {"rounds": len(self.rounds),
                "offered": dict(self.offered),
                "served": dict(self.served), "shed": dict(self.shed),
                "backlog": dict(self.backlog),
                "attainment": dict(self.attainment),
                "served_fraction": self.served_fraction(),
                "mean_fairness": float(np.mean(self.fairness))
                if self.fairness else 1.0}


DEFAULT_LADDER_GRID = (18, 32, 48, 68)   # fig_serving's serving ladder


def simulate_overload(tenants: Sequence[TenantSLO],
                      schedule: Sequence[Mapping[str, int]], *,
                      system: str = "Morpheus-ALL",
                      admission: Optional[AdmissionConfig]
                      = AdmissionConfig(),
                      budgeter: Optional[TenantSLOBudgeter] = None,
                      max_total: int = 256, headroom: float = 0.9,
                      n_cores: int = 32, seed: int = 0,
                      device=None,
                      gcfg: GovernorConfig = SERVING_GCFG,
                      candidates: Optional[Sequence[Split]] = None,
                      fixed_split: Optional[Split] = None,
                      warm_handoff: bool = True) -> OverloadResult:
    """Serve an offered-load ``schedule`` through the engine under
    per-tenant SLO budgeting and (optionally) admission control.

    ``schedule`` is one dict per round: tenant name -> offered requests
    (``workloads.overload.demand_schedule`` builds the canonical 2-10x
    step/spike/sustained shapes).  Each tenant replays its own synthetic
    trace (``TenantSLO.app``) in its own address region, the admitted
    mix is proportionally interleaved, and the engine carries one
    count-masked Stats row per tenant — per-tenant attribution stays
    exact under admission (``OverloadResult.attribution_exact``).

    ``admission=None`` runs with NO controller (the no-admission
    baseline); ``AdmissionConfig(enabled=False)`` runs the inert
    pass-through — the two are bit-identical in integer Stats and
    decision sequences.  The engine runs on ``device`` (None: the CUDA
    card, ``BackendError`` without one; ``"cpu"``: the plain versions).
    """
    dev = engine.resolve_device(device)
    tenants = list(tenants)
    K = len(tenants)
    assert K >= 1 and all(t.app for t in tenants), \
        "overload tenants need TenantSLO.app trace profiles"
    names = [t.name for t in tenants]
    spec = cs.SYSTEMS[system]
    ws_scale = 1.0 / cs.SIM_SCALE
    schedule = [{n: int(r.get(n, 0)) for n in names} for r in schedule]
    offered_tot = {n: sum(r[n] for r in schedule) for n in names}

    # per-tenant traces in disjoint address regions (the tenancy
    # composer's tagging rule); cursors advance by requests SERVED, so
    # total offered bounds every tenant's trace length
    traces = {}
    for k, t in enumerate(tenants):
        n_t = max(offered_tot[t.name], 1)
        a, w, l = tr.generate(t.app, n_cores=n_cores, length=n_t,
                              seed=seed + k, ws_scale=ws_scale)
        assert int(a.max(initial=0)) < TENANT_STRIDE_BLOCKS
        traces[t.name] = (a.astype(np.uint64)
                          + np.uint64(k * TENANT_STRIDE_BLOCKS), w, l)

    if budgeter is None:
        budgeter = TenantSLOBudgeter(tenants, min_total=1,
                                     max_total=max_total,
                                     headroom=headroom)
    ctrl = AdmissionController(tenants, admission) \
        if admission is not None else None
    primary = next((t.app for t in tenants
                    if tr.WORKLOADS[t.app].memory_bound), tenants[0].app)
    if fixed_split is not None:
        cands: List[Split] = [tuple(fixed_split)]       # type: ignore
        from dataclasses import replace
        gcfg = replace(gcfg, epsilon=0.0, epsilon_min=0.0)
    elif candidates is not None:
        cands = sorted(set(tuple(c) for c in candidates))  # type: ignore
    else:
        cands = candidates_for(primary, system, grid=DEFAULT_LADDER_GRID,
                               length=max(sum(offered_tot.values()), 1))
    gov = Governor(cands, gcfg)
    wl_shim = SimpleNamespace(tenants=tenants)  # _attribute_flush needs K

    nc, nk = gov.current
    cfg = cs.build_config(spec, nk)
    state = engine.init_state(cfg, K, dev)
    cursors = {n: 0 for n in names}
    stream_pos = 0
    pending_flush = None
    total_stats = None
    served_tot = {n: 0 for n in names}
    shed_tot = {n: 0 for n in names}
    rounds: List[Dict] = []
    fairness: List[float] = []
    dec_seen = 0

    for r, offered in enumerate(schedule):
        active = [n for n in names
                  if offered[n] > 0
                  or (ctrl is not None and ctrl.backlog(n) > 0)]
        if not active:
            rounds.append({"round": r, "offered": dict(offered),
                           "served": {n: 0 for n in names},
                           "deferred": {}, "shed": {}, "budget": {},
                           "pressure": 0.0, "round_ms": 0.0,
                           "split": gov.current, "fairness": 1.0,
                           "backlog": 0, "idle": True})
            continue
        budgets = budgeter.next_budgets(active)
        if ctrl is not None:
            plan = ctrl.plan(offered, budgets)
            serve = plan.served()
            for n, s in plan.shed.items():
                shed_tot[n] += s
            pressure = plan.pressure
        else:
            plan = None
            serve = dict(offered)
            pressure = 0.0
        counts = [serve.get(n, 0) for n in names]
        n_tot = sum(counts)
        if n_tot == 0:
            rounds.append({"round": r, "offered": dict(offered),
                           "served": dict(serve),
                           "deferred": dict(plan.deferred) if plan else {},
                           "shed": dict(plan.shed) if plan else {},
                           "budget": dict(budgets), "pressure": pressure,
                           "round_ms": 0.0, "split": gov.current,
                           "fairness": 1.0,
                           "backlog": ctrl.backlog() if ctrl else 0,
                           "idle": True})
            continue
        nc, nk = gov.current
        cfg = cs.build_config(spec, nk)
        # compose the round: per-tenant slices, proportional interleave,
        # per-tenant boolean count masks for exact Stats attribution
        tid = np.asarray(proportional_interleave(counts), np.int64)
        addrs = np.empty(n_tot, np.uint64)
        writes = np.empty(n_tot, bool)
        levels = np.empty(n_tot, np.int32)
        for k, n in enumerate(names):
            if counts[k] == 0:
                continue
            sel = tid == k
            a, w, l = traces[n]
            sl = slice(cursors[n], cursors[n] + counts[k])
            addrs[sel] = a[sl]
            writes[sel] = w[sl]
            levels[sel] = l[sl]
            cursors[n] += counts[k]
        masks = [tid == k for k in range(K)]
        pt = engine.pack(cfg, [(addrs, writes, levels, 0)] * K,
                         pos0=[stream_pos] * K, count=masks)
        state, delta_b = engine.advance_packed(cfg, pt, state, dev)
        delta_rows = Stats(*[x.cpu().numpy() for x in delta_b])
        delta = Stats(*[x.sum(axis=0) for x in delta_rows])
        stream_pos += n_tot
        if pending_flush is not None:
            # last transition's flush writebacks are real traffic:
            # charge them to this round (same rule as OnlineReplica)
            delta = Stats(*[np.add(x, f) for x, f in
                            zip(delta, pending_flush)])
            pending_flush = None
        total_stats = delta if total_stats is None else \
            Stats(*[np.add(t, x) for t, x in zip(total_stats, delta)])
        # mixed-round finalize: request-weighted instruction mix + knee,
        # dominant app by served share (ties break by tenant order)
        insts = sum(tr.instructions_for(t.app, c)
                    for t, c in zip(tenants, counts))
        knee = sum(tr.WORKLOADS[t.app].contention_knee * c
                   for t, c in zip(tenants, counts)) / n_tot
        app = tenants[int(np.argmax(counts))].app
        rr = cs._finalize(cs.RunPoint(app, system, nc, nk, n_tot, seed),
                          nc, nk, n_tot, delta, insts=insts, knee=knee)
        # per-tenant finalize over the masked rows: the cost samples the
        # budgeter learns from, and the IPC terms the fairness audit uses
        ns_by_tenant = {}
        ipcs = []
        for k, t in enumerate(tenants):
            row = Stats(*[x[k] for x in delta_rows])
            rk = cs._finalize(
                cs.RunPoint(t.app, system, nc, nk, counts[k], seed),
                nc, nk, counts[k], row)
            ipcs.append(rk.ipc)
            if counts[k] > 0:
                ns_by_tenant[t.name] = rk.exec_time_s * 1e9 / counts[k]
        round_ms = rr.exec_time_s * 1e3
        budgeter.observe(serve, round_ms, ns_by_tenant)
        fair = jains_index([x for x, c in zip(ipcs, counts) if c > 0])
        fairness.append(fair)
        if obs.metrics_on():
            obs.set_gauge("fairness_jain", fair, replica="overload")
        occ, acc, _ = _epoch_telemetry(cfg, state, delta)
        t_comp = insts / (nc * cs.IPC_PER_CORE * cs.FREQ_GHZ * 1e9)
        if t_comp >= 0.99 * rr.exec_time_s:
            hint = +1
        elif occ > 0.9:
            hint = -1
        else:
            hint = 0
        # the admission coupling: overload pressure waives the hint
        # staleness gate (docs/qos.md).  Disabled/absent controller
        # reports 0.0, keeping the governor path bit-identical.
        gov.observe(rr.ipc, hint, signature=rr.llc_hit_rate,
                    pressure=pressure)
        new_split = gov.decide() if fixed_split is None else gov.current
        flush_wbs = 0
        if new_split != (nc, nk):
            new_cfg = cs.build_config(spec, new_split[1])
            if new_cfg != cfg:
                state, rep = rt_stream.handoff(cfg, state, new_cfg,
                                               migrate=warm_handoff)
                state = _attribute_flush(state, rep, wl_shim, cfg)
                flush_wbs = rep.flush_writebacks // K
                if flush_wbs:
                    e_dram = rt_stream.flush_energy_nJ_per_block(cfg)
                    z = Stats(*[np.zeros((), np.asarray(x).dtype)
                                for x in delta])
                    pending_flush = z._replace(
                        writebacks=np.int32(flush_wbs),
                        dram_bytes=np.float32(flush_wbs * tr.BLOCK_BYTES),
                        energy_nJ=np.float32(flush_wbs * e_dram))
        for ev in gov.decisions[dec_seen:]:
            ev.replica = "overload"
            if flush_wbs and ev.switched:
                ev.flush_writebacks = flush_wbs
            ev.summary = {"hit_rate": rr.llc_hit_rate,
                          "ext_occupancy": occ, "pred_accuracy": acc,
                          "fairness": fair, "pressure": pressure}
            obs.instant("governor.decision", **ev.to_dict())
        dec_seen = len(gov.decisions)
        obs.count("epochs", 1, path="overload")
        for n in names:
            served_tot[n] += serve.get(n, 0)
        rounds.append({"round": r, "offered": dict(offered),
                       "served": dict(serve),
                       "deferred": dict(plan.deferred) if plan else {},
                       "shed": dict(plan.shed) if plan else {},
                       "budget": dict(budgets), "pressure": pressure,
                       "round_ms": round_ms, "split": (nc, nk),
                       "fairness": fair,
                       "backlog": ctrl.backlog() if ctrl else 0,
                       "attain": {n: budgeter.attainment(n)
                                  for n in names}})

    host = [x.cpu().numpy() for x in state.stats]
    tenant_stats = {t.name: Stats(*[x[k] for x in host])
                    for k, t in enumerate(tenants)}
    if total_stats is None:
        total_stats = Stats(*[np.zeros((), x.dtype) for x in host])
    return OverloadResult(
        tenants=tenants, rounds=rounds,
        stats=Stats(*[np.asarray(x) for x in total_stats]),
        tenant_stats=tenant_stats,
        events=list(ctrl.events) if ctrl is not None else [],
        decisions=list(gov.decisions),
        attainment={n: budgeter.attainment(n) for n in names},
        offered=offered_tot, served=served_tot, shed=shed_tot,
        backlog={n: (ctrl.backlog(n) if ctrl is not None else 0)
                 for n in names},
        fairness=fairness)
