"""Per-epoch runtime telemetry: ring-buffer log + JSON/CSV export (a copy
of ``repro.runtime.telemetry``).

One ``EpochRecord`` is appended per epoch by the streaming drivers
(``runtime.governor.simulate_online``, the serving governor hook).  The
log is a fixed-capacity ring buffer — a long-running server keeps the
most recent ``capacity`` epochs — with loss-free export for the benchmark
harness (``benchmarks/fig_online``) and ``tools/bench_runtime.py``.

Schema (one row per epoch, documented in docs/runtime.md):

  epoch        monotone epoch index
  pos          trace/request position at epoch start
  app          workload (phase) label observed this epoch
  n_compute    cores in compute mode during the epoch
  n_cache      cores (chips) in cache mode during the epoch
  requests     LLC/pool requests served this epoch
  hit_rate     (conv_hits + ext_hits) / lookups
  ext_occupancy   mean extended-tier byte occupancy / budget (0..1)
  pred_accuracy   (ext_hits + ext_pred_miss) / ext accesses
  bytes_saved  BDI bytes saved by resident compressed blocks
  ipc          modeled IPC of the epoch (simulator runtime)
  exec_time_s  modeled execution time of the epoch
  reward       scalar the governor optimised this epoch
  switched     True iff the governor changed the split AFTER this epoch
  flush_writebacks  dirty blocks flushed by that reconfiguration
  epsilon      governor exploration rate when the epoch was decided
  tenants      multi-tenant replay: per-tenant request counts this epoch
               ("name:count|name:count"; empty for single-trace runs)
  tenant_ipc   multi-tenant replay: per-tenant modeled IPC terms
               ("name:ipc|name:ipc") — the inputs to the QoS reward
               objectives (docs/qos.md)
  fairness     Jain's fairness index over the active tenants' IPC terms
               this epoch (1.0 for single-tenant runs) — the rolling
               fairness audit gauge (docs/qos.md)
  decision     governor decision provenance this epoch: the compact
               rendering of every ``obs.DecisionEvent`` the
               decision recorded (";"-joined, e.g.
               "hint:(32|36)->(28|40)"; empty when the governor held
               still) — docs/observability.md

Export rows are always oldest -> newest, including after the ring has
wrapped (``records()`` starts at the write head; pinned by
tests/test_obs.py against a wrapped log).
"""
from __future__ import annotations

import csv
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence


@dataclass
class EpochRecord:
    epoch: int
    pos: int
    app: str
    n_compute: int
    n_cache: int
    requests: int
    hit_rate: float
    ext_occupancy: float
    pred_accuracy: float
    bytes_saved: float
    ipc: float
    exec_time_s: float
    reward: float
    switched: bool = False
    flush_writebacks: int = 0
    epsilon: float = 0.0
    # multi-tenant replay: per-tenant request counts this epoch, rendered
    # "name:count|name:count" (empty for single-trace runs)
    tenants: str = ""
    # multi-tenant replay: per-tenant modeled IPC terms this epoch
    # ("name:ipc|name:ipc"; what the QoS objectives weigh — docs/qos.md)
    tenant_ipc: str = ""
    # rolling Jain's fairness index over the per-tenant IPC terms this
    # epoch (1.0 for single-tenant runs and perfectly even mixes; the
    # fairness audit gauge — docs/observability.md, docs/qos.md)
    fairness: float = 1.0
    # governor decision provenance: compact DecisionEvent renderings,
    # ";"-joined (empty when the governor held still) —
    # docs/observability.md
    decision: str = ""

    def to_dict(self) -> Dict:
        return asdict(self)


FIELDS = list(EpochRecord.__dataclass_fields__)


def jains_index(xs: Sequence[float]) -> float:
    """Jain's fairness index J(x) = (Σx)² / (n·Σx²) over non-negative
    allocations; 1.0 means perfectly even, 1/n means one tenant takes
    everything.  Exact by construction at the boundary cases the audit
    relies on: K ≤ 1 and all-equal inputs return exactly 1.0 (no float
    round-off), an all-zero vector reads as fair (nothing allocated,
    nobody disadvantaged)."""
    xs = [float(x) for x in xs]
    n = len(xs)
    if n <= 1 or len(set(xs)) == 1:
        return 1.0
    s = sum(xs)
    sq = sum(x * x for x in xs)
    if sq <= 0.0:
        return 1.0
    return (s * s) / (n * sq)


class TelemetryLog:
    """Fixed-capacity ring buffer of ``EpochRecord``s (oldest dropped)."""

    def __init__(self, capacity: int = 4096):
        assert capacity > 0
        self.capacity = capacity
        self._buf: List[Optional[EpochRecord]] = [None] * capacity
        self._next = 0          # next write slot
        self._count = 0         # records currently held (<= capacity)
        self.total = 0          # records ever appended

    def append(self, rec: EpochRecord) -> None:
        self._buf[self._next] = rec
        self._next = (self._next + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)
        self.total += 1

    def __len__(self) -> int:
        return self._count

    def records(self) -> List[EpochRecord]:
        """Held records, oldest first."""
        if self._count < self.capacity:
            return [r for r in self._buf[:self._count]]
        head = self._next
        return self._buf[head:] + self._buf[:head]  # type: ignore

    def tail(self, n: int) -> List[EpochRecord]:
        # [-0:] would return everything — an empty tail must be empty
        return self.records()[-n:] if n > 0 else []

    # ------------------------------------------------------------- export
    def to_json(self, path: str | Path | None = None) -> str:
        payload = json.dumps([r.to_dict() for r in self.records()], indent=1)
        if path is not None:
            Path(path).write_text(payload)
        return payload

    def to_csv(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w", newline="") as f:
            w = csv.writer(f)
            w.writerow(FIELDS)
            for r in self.records():
                d = r.to_dict()
                w.writerow([d[k] for k in FIELDS])
        return path

    def extend(self, recs: Sequence[EpochRecord]) -> None:
        for r in recs:
            self.append(r)

    # ------------------------------------------------------------ summary
    def summary(self) -> Dict:
        recs = self.records()
        if not recs:
            return {"epochs": 0}
        switches = sum(r.switched for r in recs)
        t = sum(r.exec_time_s for r in recs)
        insts = sum(r.ipc * r.exec_time_s for r in recs)  # ipc-weighted
        return {
            "epochs": len(recs),
            "requests": sum(r.requests for r in recs),
            "switches": switches,
            "mean_hit_rate": sum(r.hit_rate for r in recs) / len(recs),
            "mean_ipc": sum(r.ipc for r in recs) / len(recs),
            "time_weighted_ipc": insts / t if t > 0 else 0.0,
            "flush_writebacks": sum(r.flush_writebacks for r in recs),
            "final_split": (recs[-1].n_compute, recs[-1].n_cache),
        }


def merge_logs(logs: Sequence[TelemetryLog],
               capacity: Optional[int] = None) -> TelemetryLog:
    """One log holding every replica's records (the fleet's aggregate
    export path).  Records interleave by epoch index — epoch 0 of every
    replica, then epoch 1, ... — with ties kept in input (replica)
    order, so exporting the merged log reads as the fleet's timeline.
    The source logs are not modified."""
    recs = [r for log in logs for r in log.records()]
    recs.sort(key=lambda r: r.epoch)     # stable: ties keep replica order
    out = TelemetryLog(capacity if capacity is not None
                       else max(len(recs), 1))
    out.extend(recs)
    return out
