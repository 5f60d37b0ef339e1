"""Fleet runtime: advance N governed replicas per engine dispatch, after
``repro.runtime.fleet``.

The scalar runtime (``runtime.governor.simulate_online``) advances ONE
replica per ``engine.advance_packed`` dispatch.  Here each replica is an
``OnlineReplica`` (the same prologue and host epilogue as the scalar
path); per fleet step the live replicas are grouped by their current
engine config (identical ``MorpheusConfig`` means identical state
shapes), each group's trace slices are packed in ONE ``engine.pack``
call, the replicas' ``EngineState`` rows are concatenated along dim 0
(one ``torch.cat`` a leaf), padded with no-op rows to a power-of-two
row count (``fleet_padding``), and the whole group advances through one
``engine._run_packed_state`` call: on the card one stateful
``conv_scan`` launch, and one ``ext_scan`` launch when the split has
cache cores, whatever the replica count.  Each replica gets row views
(``narrow``) of the new state back; the scans write fresh output
tensors, so no later step writes into a view another replica holds.

The group's Stats delta (its ``(B, NI)`` int and ``(B, NF)`` float
vectors), ``ext_used`` and ``ext_valid`` come back to the host in ONE
read-back: non-blocking copies into pinned buffers and one
synchronisation.  A group epoch on the card therefore synchronises a
fixed number of times whatever its replica count (CUDA's sync debug
mode counts 15 at a split with cache cores, ``chip_smoke.py`` phase
15): the ten copies of ``engine.to_device``, the row contract's checks
(``engine_scan.check_row_contract``: a verdict a scan launch, and two
more in the extended rows' size check), and that read-back.

Each state row's sets are independent and the engine sums a row's sets
in a fixed order (``engine._set_sum``), so a fleet replica is
identical to its serial run: integer Stats and decisions exactly,
floats to the last bit.  ``tests/test_torch_fleet.py`` holds the port to
the reference and to its own serial loop.

``SplitAdvisor`` is the cross-replica memory (best split and phase /
context tables a workload mix converged to); a fresh replica of a known
mix warm-starts there.

Over a ``("fleet",)`` mesh of N ranks (``launch.mesh.make_fleet_mesh``,
the reference's ``shard_map`` over that axis) every rank runs the whole
fleet's host logic, and each group of B rows pads to
``sharding.fleet_padding(B, mesh)`` (a power of two that the axis
tiles).  Rank r packs and advances rows ``[r P/N, (r+1) P/N)`` of the P
padded rows through ``_run_packed_state`` (on the card, the stateful
scans on its rows, the row contract checked on them), then the ranks
all-gather the Stats delta vectors and the new state rows: on ``gloo``
one read-back of the rank's rows and the gather on the host, on NCCL
the gather on the card.  Every rank's epilogue then consumes the whole
group, as the reference's single controller does: the host logic is
deterministic from the integer Stats, so no decision is broadcast, and
every rank holds every replica's state.  A mesh without a fleet axis
(or of one rank) runs the group whole, as the reference does.

Entry points take ``device`` (None: the CUDA card, ``BackendError``
without one; ``"cpu"``: the plain versions) where the reference takes
``backend``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..core import cache_sim as cs
from ..core import engine
from ..core.controller import Stats
from ..core.engine import EngineState
from ..distributed import collectives as C
from ..distributed.sharding import (FLEET_AXIS, axis_sizes, coordinate,
                                    fleet_padding)
from ..kernels import engine_scan
from .governor import GovernorConfig, OnlineReplica, OnlineResult
from .telemetry import EpochRecord, TelemetryLog, merge_logs

Split = Tuple[int, int]


@dataclass
class ReplicaSpec:
    """Constructor arguments of one fleet replica (``OnlineReplica``).

    ``phases`` is anything ``simulate_online`` accepts: one app name, a
    sequence of apps replayed back to back, or a composed multi-tenant
    ``workloads.Workload`` (each tenant contributes one state row to the
    fleet batch).  ``slo`` is an optional per-tenant SLO budgeter
    (``workloads.serving.TenantSLOBudgeter``), one instance per spec.
    """
    phases: object
    system: str = "Morpheus-ALL"
    length: int = 60_000
    epoch_len: int = 3_000
    window_s: Optional[float] = None
    target_epoch: Optional[int] = None
    seed: int = 0
    gcfg: GovernorConfig = field(default_factory=GovernorConfig)
    candidates: Optional[Sequence[Split]] = None
    fixed_split: Optional[Split] = None
    warm_handoff: bool = True
    burn_in: Optional[int] = None
    name: str = ""
    slo: Optional[object] = None

    def build(self, device=None) -> OnlineReplica:
        return OnlineReplica(
            self.phases, self.system, length=self.length,
            epoch_len=self.epoch_len, window_s=self.window_s,
            target_epoch=self.target_epoch, seed=self.seed,
            gcfg=self.gcfg, candidates=self.candidates,
            fixed_split=self.fixed_split, warm_handoff=self.warm_handoff,
            burn_in=self.burn_in, name=self.name, slo=self.slo,
            device=device)


class SplitAdvisor:
    """Shared cross-replica split memory, keyed by workload mix.

    Replicas report their governor's best-estimated split, with the
    phase/context tables of a ``Governor.export_state`` snapshot, under
    their ``OnlineReplica.mix_key``.  Building a replica for a known mix
    warm-starts it at the advised split and, when the candidate ladders
    match, with the phase/context tables.  The advice is a prior, not a
    constraint: estimates start fresh.
    """

    def __init__(self):
        self.table: Dict[Tuple, Dict] = {}
        self.reports = 0
        self.warm_starts = 0

    def report(self, rep: OnlineReplica) -> None:
        """Record a replica's current best estimate for its mix; the mix
        entry keeps whichever replica's estimate is highest."""
        gov = rep.gov
        if rep.fixed_split is not None or not gov.measured:
            return
        best = gov.best_estimate()
        if best is None:
            return
        split, est = best
        self.reports += 1
        e = self.table.get(rep.mix_key)
        if e is not None and est < e["est"]:
            return
        s = gov.export_state()
        self.table[rep.mix_key] = {
            "split": tuple(split), "est": float(est),
            "candidates": tuple(gov.candidates),
            "phase_table": dict(s.phase_table),
            "ctx_table": dict(s.ctx_table)}

    def warm_start(self, rep: OnlineReplica) -> bool:
        """Seed a FRESH replica (no epochs consumed yet) from its mix's
        remembered entry; returns whether advice was applied."""
        gov = rep.gov
        e = self.table.get(rep.mix_key)
        if e is None or rep.fixed_split is not None or gov.epoch > 0:
            return False
        cands = tuple(gov.candidates)
        want = e["split"]
        j = cands.index(want) if want in cands else min(
            range(len(cands)), key=lambda k: abs(cands[k][0] - want[0]))
        # on a fresh governor this is exactly ``Governor(initial=j)``
        gov._i = j
        if cands == e["candidates"]:
            gov.phase_table.update(e["phase_table"])
            gov.ctx_table.update(e["ctx_table"])
        # state shapes are per config: rebuild the (still empty) state for
        # the advised split, on the replica's device
        rep.state = engine.init_state(
            cs.build_config(rep.spec, gov.current[1]), rep.n_tenants,
            rep.device)
        self.warm_starts += 1
        return True


def build_replicas(specs: Sequence[ReplicaSpec],
                   advisor: Optional[SplitAdvisor] = None,
                   device=None) -> List[OnlineReplica]:
    """Build every spec on ``device``; warm-start each from the advisor
    when given."""
    reps = []
    for spec in specs:
        rep = spec.build(device)
        if advisor is not None:
            advisor.warm_start(rep)
        reps.append(rep)
    return reps


# ------------------------------------------------------------ fleet step

_ROW_FIELDS = tuple(f for f in EngineState._fields if f != "stats")
# places of ext_used and ext_valid in a group's carry (the two Stats
# vectors, then the row fields)
_USED = 2 + _ROW_FIELDS.index("ext_used")
_VALID = 2 + _ROW_FIELDS.index("ext_valid")
_EMPTY_TRACE = (np.zeros(0, np.uint32), np.zeros(0, bool),
                np.zeros(0, np.int32), 0)


def _mesh_devices(mesh) -> int:
    """Devices of a mesh (the product of its axis sizes); None is one."""
    if mesh is None:
        return 1
    return int(np.prod(list(axis_sizes(mesh).values()) or [1]))


class _FleetAxis(NamedTuple):
    """This rank's place on the fleet axis: ``n`` ranks, index ``r``,
    the axis' process group (None for one rank)."""
    n: int = 1
    r: int = 0
    group: object = None


def _fleet_axis(mesh) -> _FleetAxis:
    n = axis_sizes(mesh).get(FLEET_AXIS, 1) if mesh is not None else 1
    if n == 1:
        return _FleetAxis()
    if not (dist.is_initialized() and hasattr(mesh, "get_group")):
        raise RuntimeError(f"simulate_fleet over a fleet axis of {n}: a "
                           f"DeviceMesh over an initialised world is needed "
                           f"(repro_torch.launch.mesh.make_fleet_mesh)")
    return _FleetAxis(n, coordinate(mesh)[FLEET_AXIS],
                      mesh.get_group(FLEET_AXIS))


@lru_cache(maxsize=None)
def _pad_state(cfg, pad: int, device: torch.device) -> EngineState:
    # fresh rows fed zero-length traces: provable no-ops, never mutated
    return engine.init_state(cfg, pad, device)


def _cat_states(states: Sequence[EngineState]) -> EngineState:
    """One ``torch.cat`` a state leaf along the row dim."""
    if len(states) == 1:
        return states[0]
    leaves = {f: torch.cat([getattr(s, f) for s in states])
              for f in _ROW_FIELDS}
    stats = Stats(*[torch.cat(xs) for xs in zip(*[s.stats
                                                  for s in states])])
    return EngineState(stats=stats, **leaves)


def _rows(state: EngineState, start: int, n: int) -> EngineState:
    """Rows ``start:start + n`` of every leaf, as views."""
    leaves = {f: getattr(state, f).narrow(0, start, n)
              for f in _ROW_FIELDS}
    return EngineState(stats=Stats(*[x.narrow(0, start, n)
                                     for x in state.stats]), **leaves)


def _read_back(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host numpy copies of ``tensors`` with ONE synchronisation: on the
    card non-blocking copies into pinned buffers, then one stream sync."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in hosts]


def _gather_rows(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Every fleet rank's rows of each tensor, in rank order: on ``gloo``
    one read-back and the gather on the host (host tensors back), on NCCL
    on the card."""
    if dist.get_backend(group) == "gloo":
        tensors = [torch.from_numpy(a) for a in _read_back(tensors)]
    return [C.all_gather_rows(t, group) for t in tensors]


def _advance_group(cfg, group, device: torch.device, mesh=None) -> None:
    """Advance one same-config group of replicas in a single engine call
    (a rank's block of its rows over a fleet axis).

    ``group`` is ``[(replica, traces, pos0, count)]`` from each replica's
    ``epoch_inputs()``.  The rows pack in one call, advance in one
    ``_run_packed_state`` and read back once; each replica then consumes
    its row slice."""
    fleet = _fleet_axis(mesh)
    traces, pos0, count, rows = [], [], [], []
    for rep, t, p, m in group:
        rows.append((rep, len(t)))
        traces.extend(t)
        pos0.extend(p)
        count.extend(m if m is not None else [None] * len(t))
    b = len(traces)
    pad = fleet_padding(b, mesh)
    per = (b + pad) // fleet.n
    lo = fleet.r * per
    with obs.span("fleet.group_step", replicas=len(group), rows=b,
                  pad=pad,
                  config=f"conv{cfg.amap.conv_sets}/"
                         f"ext{cfg.amap.ext_sets}"):
        if pad:
            traces.extend([_EMPTY_TRACE] * pad)
            pos0.extend([0] * pad)
            count.extend([None] * pad)
        mine = slice(lo, lo + per)
        pt = engine.to_device(engine.pack(cfg, traces[mine],
                                          pos0=pos0[mine],
                                          count=count[mine]), device)
        states = [rep.state for rep, _ in rows]
        if pad:
            states.append(_pad_state(cfg, pad, device))
        state = _cat_states(states)
        if fleet.n > 1:
            state = _rows(state, lo, per)
        new_state, delta = engine._run_packed_state(cfg, pt, state)
        # the fleet calls _run_packed_state, bypassing advance_packed's
        # counter site
        obs.count("engine_dispatches", 1, path="fleet")
        ints, flts = engine_scan.stats_to_vecs(delta)
        carry = [ints, flts] + [getattr(new_state, f) for f in _ROW_FIELDS] \
            + list(new_state.stats)
        n = len(_ROW_FIELDS)
        if fleet.n > 1:
            with obs.span("fleet.gather", ranks=fleet.n, rows=b + pad):
                carry = _gather_rows(carry, fleet.group)
            if obs.metrics_on():
                obs.count("fleet_gather_bytes",
                          sum(x.numel() * x.element_size() for x in carry))
            new_state = EngineState(
                stats=Stats(*[x.to(device) for x in carry[2 + n:]]),
                **{f: x.to(device) for f, x in zip(_ROW_FIELDS, carry[2:])})
        out = [carry[0], carry[1], carry[_USED], carry[_VALID]]
        inspecting = obs.inspector() is not None
        if inspecting:
            # the decoded snapshots need the whole carry on the host: the
            # state's leaves join the same read-back
            out += carry[2:]
        host = _read_back(out)
        h_ints, h_flts, h_used, h_valid = host[:4]
        if obs.metrics_on():
            obs.count("device_get_bytes",
                      sum(x.nbytes for x in (h_ints, h_flts, h_used,
                                             h_valid)))
        host_state = None
        if inspecting:
            leaves = [torch.from_numpy(x) for x in host[4:]]
            host_state = EngineState(stats=Stats(*leaves[n:]),
                                     **dict(zip(_ROW_FIELDS, leaves)))
        o = 0
        for rep, k in rows:
            sl = slice(o, o + k)
            d = engine_scan.vecs_to_stats(h_ints[sl], h_flts[sl])
            rep.consume(_rows(new_state, o, k),
                        Stats(*[np.ascontiguousarray(x) for x in d]),
                        ext_used=h_used[sl], ext_valid=h_valid[sl],
                        host_state=None if host_state is None
                        else _rows(host_state, o, k))
            o += k


# ----------------------------------------------------------- entry points

def convergence_epoch(records: Sequence[EpochRecord]) -> int:
    """First epoch from which the run never left its final split again
    (0: started there and stayed) — the figure's convergence metric."""
    if not records:
        return 0
    final = (records[-1].n_compute, records[-1].n_cache)
    c = 0
    for i, r in enumerate(records):
        if (r.n_compute, r.n_cache) != final:
            c = i + 1
    return c


@dataclass
class FleetResult:
    """Outcome of one ``simulate_fleet`` run."""
    results: List[OnlineResult]       # per replica, spec order
    names: List[str]
    epochs: int                       # fleet steps taken (max over replicas)
    dispatches: int                   # engine dispatches issued
    mesh_devices: int
    device: str
    advisor: Optional[SplitAdvisor] = None

    @property
    def n_replicas(self) -> int:
        return len(self.results)

    def merged_log(self, capacity: Optional[int] = None) -> TelemetryLog:
        """Every replica's telemetry in one epoch-interleaved log."""
        return merge_logs([r.log for r in self.results], capacity)

    def aggregate_ipc(self) -> float:
        """Fleet-aggregate modeled IPC: total instructions retired over
        total modeled time (the time-weighted mean of replica IPCs)."""
        t = sum(r.exec_time_s for r in self.results)
        insts_over_freq = sum(r.ipc * r.exec_time_s for r in self.results)
        return insts_over_freq / t if t > 0 else 0.0

    def convergence_epochs(self) -> List[int]:
        return [convergence_epoch(r.records) for r in self.results]

    def summary(self) -> Dict:
        conv = self.convergence_epochs()
        return {
            "replicas": self.n_replicas,
            "epochs": self.epochs,
            "dispatches": self.dispatches,
            "mesh_devices": self.mesh_devices,
            "device": self.device,
            "aggregate_ipc": self.aggregate_ipc(),
            "mean_convergence_epoch": float(np.mean(conv)) if conv else 0.0,
            "switches": sum(r.switches for r in self.results),
            "warm_starts": 0 if self.advisor is None
            else self.advisor.warm_starts,
        }


def _build(specs, device: torch.device) -> List[OnlineReplica]:
    reps = [s if isinstance(s, OnlineReplica) else s.build(device)
            for s in specs]
    for rep in reps:
        if rep.device.type != device.type:
            raise ValueError(f"replica {rep.name} lies on {rep.device}, "
                             f"not {device}")
    return reps


def simulate_fleet(specs, *, device=None, mesh=None,
                   advisor: Optional[SplitAdvisor] = None) -> FleetResult:
    """Advance a fleet of replicas, one engine call per (config group,
    step).

    ``specs`` is a sequence of ``ReplicaSpec`` (or pre-built
    ``OnlineReplica`` on ``device``).  Per step, live replicas running the
    same engine config advance together; replicas the governors have
    steered to different splits form separate groups.  ``mesh``: a
    ``("fleet",)`` mesh from ``launch.mesh.make_fleet_mesh`` shards each
    group's rows over its ranks (every rank of the mesh calls this with
    the same specs); None runs on one device.  ``advisor`` warm-starts
    fresh replicas and collects per-epoch reports.
    """
    _fleet_axis(mesh)                   # a fleet axis needs a world
    dev = engine.resolve_device(device)
    reps = _build(specs, dev)
    if advisor is not None:
        for rep in reps:
            advisor.warm_start(rep)
    dispatches = 0
    steps = 0
    while True:
        live = [r for r in reps if not r.done]
        if not live:
            break
        groups: Dict = {}
        for rep in live:
            cfg, traces, pos0, count = rep.epoch_inputs()
            groups.setdefault(cfg, []).append((rep, traces, pos0, count))
        for cfg, group in groups.items():
            _advance_group(cfg, group, dev, mesh)
            dispatches += 1
        if advisor is not None:
            for rep in live:
                advisor.report(rep)
        steps += 1
    return FleetResult(results=[r.result() for r in reps],
                       names=[r.name for r in reps], epochs=steps,
                       dispatches=dispatches,
                       mesh_devices=_mesh_devices(mesh), device=dev.type,
                       advisor=advisor)


def evaluate_governors(cells, gcfgs, *, system: str = "Morpheus-ALL",
                       candidates=None, target_epoch: Optional[int] = None,
                       epoch_len: int = 3_000, device=None, mesh=None
                       ) -> List[List[OnlineResult]]:
    """Score K governor configs over M workload cells as ONE fleet run.

    Every (config, cell) pair becomes one ``OnlineReplica`` replaying the
    same recorded workload under its own governor; the K x M population
    advances through ``simulate_fleet``.  ``candidates`` is one shared
    ladder or a per-cell sequence of ladders.  Returns ``results[k][m]``
    (config ``gcfgs[k]`` on ``cells[m]``), identical per replica to
    K x M ``simulate_online`` calls.
    """
    cells = list(cells)
    if candidates is None or (candidates and
                              isinstance(candidates[0], tuple)):
        ladders = [candidates] * len(cells)
    else:
        ladders = list(candidates)
        assert len(ladders) == len(cells), \
            f"{len(ladders)} ladders for {len(cells)} cells"
    specs = [ReplicaSpec(cell, system, epoch_len=epoch_len,
                         target_epoch=target_epoch, gcfg=gcfg,
                         candidates=ladders[m], name=f"g{k}/c{m}")
             for k, gcfg in enumerate(gcfgs)
             for m, cell in enumerate(cells)]
    fr = simulate_fleet(specs, device=device, mesh=mesh)
    m = len(cells)
    return [fr.results[k * m:(k + 1) * m] for k in range(len(gcfgs))]


def run_serial(specs, *, device=None) -> List[OnlineResult]:
    """The Python-loop baseline: every replica advanced one at a time, one
    ``advance_packed`` per replica per epoch — ``simulate_online``'s
    loop.  The identity reference of the fleet and the denominator of
    its speedup."""
    dev = engine.resolve_device(device)
    reps = _build(specs, dev)
    for rep in reps:
        while not rep.done:
            cfg, traces, pos0, count = rep.epoch_inputs()
            pt = engine.pack(cfg, traces, pos0=pos0, count=count)
            state, delta_b = engine.advance_packed(cfg, pt, rep.state, dev)
            host = Stats(*[x.cpu().numpy() for x in delta_b])
            if obs.metrics_on():
                obs.count("device_get_bytes", sum(x.nbytes for x in host))
            rep.consume(state, host)
    return [rep.result() for rep in reps]
