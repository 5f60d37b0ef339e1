"""Multi-tenant workload composition: K tenants sharing one LLC (a copy
of ``repro.workloads.tenancy``; ``attribute_stats`` runs the port's
engine on a ``device`` argument).

A ``Tenant`` pairs a trace source with an arrival process and a share of
the total request volume.  ``compose`` materializes the contended stream
the cache actually sees:

  * each tenant's trace is generated independently, then its block
    addresses are offset into a disjoint tenant address region
    (``TENANT_STRIDE_BLOCKS``) — tenants never share data, but their
    requests land in the same cache sets, which is exactly the contention
    the governor must arbitrate;
  * each tenant's requests are timestamped by its arrival process and the
    K streams are merged by arrival time (stable, deterministic
    tie-breaks), so a bursty tenant shoulders aside a steady one;
  * the per-request ``tenant_id`` column keeps attribution: per-tenant
    Stats are recovered *exactly* (integer bit-identity) by replaying the
    composed stream once per tenant with a count mask — state evolution
    is identical in every replay (same requests in the same order), only
    which requests are *counted* differs, so the per-tenant Stats sum to
    the global Stats by construction (tests/test_workloads.py).

The product is a ``Workload``: the object ``runtime.stream.EpochStream``
and ``runtime.governor.simulate_online`` accept in place of a raw trace.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import arrivals as arr
from . import sources as src
from . import synthetic

# Disjoint per-tenant address regions: 2^22 blocks (512 MiB at 128 B) is
# larger than any synthetic working set, so tenant address spaces never
# alias while still contending for the same sets (region % total_sets
# spreads over all sets).
TENANT_STRIDE_BLOCKS = 1 << 22


@dataclass(frozen=True)
class Tenant:
    """One tenant: who it is, what it runs, how its requests arrive.

    ``window`` is the tenant's activity window as fractions of the
    composed stream's wall-clock span: ``(0.0, 1.0)`` (the default) is a
    tenant present for the whole stream; ``(0.3, 1.0)`` arrives 30% in;
    ``(0.0, 0.6)`` departs at 60%.  Arriving/departing tenants are the
    *churn* the QoS governor must re-converge through (docs/qos.md).
    """
    name: str
    source: src.TraceSource
    arrival: arr.ArrivalProcess
    weight: float = 1.0            # share of the composed request volume
    window: Tuple[float, float] = (0.0, 1.0)

    def __post_init__(self):
        a, b = self.window
        assert 0.0 <= a < b <= 1.0, \
            f"tenant {self.name}: bad activity window {self.window}"

    @property
    def app(self) -> str:
        """Synthetic profile for the analytical model (reward terms)."""
        return self.source.app


class Workload:
    """A composed, materialized, timestamped multi-tenant request stream.

    Parallel arrays (arrival order): ``addrs``/``writes``/``levels`` (the
    engine triple, addresses tenant-tagged), ``tenant_id`` (int32 index
    into ``tenants``) and ``t_s`` (float64 arrival seconds).
    """

    def __init__(self, tenants: Sequence[Tenant], addrs, writes, levels,
                 tenant_id, t_s, *, n_cores: int, seed: int):
        self.tenants = tuple(tenants)
        self.addrs = np.asarray(addrs, np.uint32)
        self.writes = np.asarray(writes, bool)
        self.levels = np.asarray(levels, np.int32)
        self.tenant_id = np.asarray(tenant_id, np.int32)
        self.t_s = np.asarray(t_s, np.float64)
        self.n_cores = int(n_cores)
        self.seed = int(seed)
        n = len(self.addrs)
        assert (len(self.writes) == len(self.levels) == len(self.tenant_id)
                == len(self.t_s) == n), "column length mismatch"
        # realized activity interval per tenant: [first, last] arrival.
        # Windows are *placed* by compose in its own span frame; activity
        # tests must use the realized intervals, never re-derive window
        # fractions from the stream span — with per-tenant arrival rates
        # (or stochastic arrivals) the two frames disagree, and a tenant
        # would read as departed while its requests are still arriving.
        self._activity = []
        for k in range(len(self.tenants)):
            ts_k = self.t_s[self.tenant_id == k]
            self._activity.append((float(ts_k[0]), float(ts_k[-1]))
                                  if len(ts_k) else (0.0, -1.0))

    # ------------------------------------------------------------ basics
    def __len__(self) -> int:
        return len(self.addrs)

    @property
    def names(self) -> List[str]:
        return [t.name for t in self.tenants]

    @property
    def primary_app(self) -> str:
        """First memory-bound tenant app (drives candidate grids), else
        the first tenant's app."""
        for t in self.tenants:
            if synthetic.WORKLOADS[t.app].memory_bound:
                return t.app
        return self.tenants[0].app

    def describe(self) -> str:
        parts = [f"{t.name}={t.source.name}@{type(t.arrival).__name__}"
                 for t in self.tenants]
        return " + ".join(parts)

    # ----------------------------------------------------------- epoching
    def epoch_bounds(self, *, epoch_len: Optional[int] = None,
                     window_s: Optional[float] = None,
                     target_epoch: Optional[int] = None
                     ) -> List[Tuple[int, int]]:
        """Epoch [lo, hi) bounds over the composed stream.

        Exactly one of: ``epoch_len`` (fixed request count — the classic
        EpochStream split), ``window_s`` (fixed wall-clock window:
        variable-size epochs under bursty arrivals), or ``target_epoch``
        (sugar: the window sized so the *mean* epoch holds about that
        many requests — bursts still produce fat epochs).
        """
        given = [x is not None for x in (epoch_len, window_s, target_epoch)]
        assert sum(given) <= 1, "pick one epoching mode"
        min_req = 1
        if window_s is None and target_epoch is not None:
            span = float(self.t_s[-1] - self.t_s[0]) if len(self) > 1 else 0.0
            if span <= 0:
                return arr.epochs_by_count(len(self), int(target_epoch))
            window_s = span * target_epoch / len(self)
            # near-empty off-period windows teach the governor nothing but
            # noise: merge them forward until an epoch carries real signal
            min_req = max(1, int(target_epoch) // 8)
        if window_s is not None:
            return arr.epochs_by_time(self.t_s, window_s,
                                      min_requests=min_req)
        return arr.epochs_by_count(len(self), int(epoch_len or 4096))

    # -------------------------------------------------------- attribution
    def tenant_masks(self, lo: int = 0, hi: Optional[int] = None
                     ) -> List[np.ndarray]:
        """Per-tenant boolean count masks over [lo, hi)."""
        hi = len(self) if hi is None else hi
        tid = self.tenant_id[lo:hi]
        return [tid == k for k in range(len(self.tenants))]

    def tenant_counts(self, lo: int = 0, hi: Optional[int] = None
                      ) -> np.ndarray:
        hi = len(self) if hi is None else hi
        return np.bincount(self.tenant_id[lo:hi],
                           minlength=len(self.tenants))

    def instructions(self, lo: int = 0, hi: Optional[int] = None) -> float:
        """Modeled warp instructions for the slice: each tenant's requests
        carry its own app's arithmetic intensity."""
        counts = self.tenant_counts(lo, hi)
        return float(sum(
            synthetic.WORKLOADS[t.app].inst_per_access * int(c)
            for t, c in zip(self.tenants, counts)))

    def contention_knee(self, lo: int = 0, hi: Optional[int] = None) -> float:
        """Request-weighted mean DRAM-contention knee of the slice."""
        counts = self.tenant_counts(lo, hi)
        tot = int(counts.sum())
        if tot == 0:
            return 72.0
        return float(sum(
            synthetic.WORKLOADS[t.app].contention_knee * int(c)
            for t, c in zip(self.tenants, counts)) / tot)

    def app_at(self, lo: int, hi: Optional[int] = None) -> str:
        """Dominant tenant's app over the slice (telemetry label)."""
        counts = self.tenant_counts(lo, hi)
        return self.tenants[int(np.argmax(counts))].app

    # --------------------------------------------------------------- churn
    @property
    def span_s(self) -> float:
        """Wall-clock span of the composed stream (activity windows are
        fractions of this)."""
        return float(self.t_s[-1] - self.t_s[0]) if len(self) > 1 else 0.0

    def has_churn(self) -> bool:
        return any(t.window != (0.0, 1.0) for t in self.tenants)

    def active_mask(self, lo: int, hi: Optional[int] = None) -> np.ndarray:
        """(K,) bool: which tenants are *active* over the slice.

        Activity is the tenant's realized activity interval (its first
        to last arrival — where its window actually landed) overlapping
        the slice's wall-clock range, not per-epoch request presence: a
        bursty tenant silent for one mid-stream epoch does not read as
        departed (that would flap the governor's churn detector).  The
        interval frame guarantees the invariant EpochStream's churn
        masks rely on — an inactive tenant has NO requests in the slice
        — for any mix of per-tenant arrival rates.
        """
        hi = len(self) if hi is None else hi
        if hi <= lo or len(self) == 0 or not self.has_churn():
            return np.ones(len(self.tenants), bool)
        t_lo = float(self.t_s[lo])
        t_hi = float(self.t_s[hi - 1])
        return np.array([a <= t_hi and t_lo <= b
                         for a, b in self._activity], bool)

    def active_signature(self, lo: int, hi: Optional[int] = None) -> int:
        """Bitmask of the active tenants over the slice — the governor
        keys its phase table on this, so a churn event (signature change)
        never collides with a same-mix phase's memory."""
        return int(np.sum(self.active_mask(lo, hi)
                          * (1 << np.arange(len(self.tenants)))))

    def epoch_active_masks(self, bounds: Sequence[Tuple[int, int]]
                           ) -> List[np.ndarray]:
        """Per-epoch active-tenant masks for a set of epoch bounds."""
        return [self.active_mask(lo, hi) for lo, hi in bounds]


def compose(tenants: Sequence[Tenant], *, length: int, n_cores: int,
            seed: int = 0, ws_scale: float = 1.0) -> Workload:
    """Materialize a composed multi-tenant ``Workload``.

    Request volume is split by tenant weight scaled by activity-window
    width (a tenant present for half the stream at weight 1 sends half
    the requests of a full-stream weight-1 tenant — its *rate* while
    active is what the weight fixes); every tenant's generator and
    arrival process get distinct derived seeds, so the composition is
    deterministic in ``seed`` alone.
    """
    tenants = list(tenants)
    assert tenants, "compose needs at least one tenant"
    assert length >= len(tenants), "fewer requests than tenants"
    widths = [t.window[1] - t.window[0] for t in tenants]
    wsum = sum(max(t.weight, 0.0) * w for t, w in zip(tenants, widths))
    assert wsum > 0, "all tenant weights are zero"
    shares = [max(t.weight, 0.0) * w / wsum
              for t, w in zip(tenants, widths)]
    # largest-remainder apportionment with a 1-request floor: counts sum
    # to EXACTLY length (length >= K asserted above), so downstream
    # length-derived artifacts never mismatch len(workload)
    counts = [max(int(s * length), 1) for s in shares]
    order = sorted(range(len(shares)),
                   key=lambda k: -(shares[k] * length
                                   - int(shares[k] * length)))
    i = 0
    while sum(counts) != length:
        k = order[i % len(counts)]
        step = 1 if sum(counts) < length else -1
        if counts[k] + step >= 1:
            counts[k] += step
        i += 1

    a_parts, w_parts, l_parts, tid_parts, ts_parts, seq_parts = \
        [], [], [], [], [], []
    for k, (t, n_t) in enumerate(zip(tenants, counts)):
        a, w, l = t.source.generate(n_cores=n_cores, length=n_t,
                                    seed=seed + 7 * k, ws_scale=ws_scale)
        # the no-alias invariant (and flush attribution's owner recovery)
        # needs every raw address inside the tenant's stride region; true
        # for all synthetic working sets, but a recorded corpus trace can
        # carry arbitrary addresses — fail loudly, never alias silently
        assert int(a.max(initial=0)) < TENANT_STRIDE_BLOCKS, \
            (f"tenant {t.name}: source addresses reach "
             f"{int(a.max(initial=0))} >= TENANT_STRIDE_BLOCKS "
             f"({TENANT_STRIDE_BLOCKS}); rebase/scale the trace")
        a = a.astype(np.uint64) + np.uint64(k * TENANT_STRIDE_BLOCKS)
        assert a.max(initial=0) < np.uint64(2) ** 32, \
            "tenant-tagged address overflows uint32"
        ts = np.asarray(t.arrival.timestamps(n_t, seed=seed + 7 * k + 3),
                        np.float64)
        # phase-stagger tenant clocks by k/K of the tenant's mean period:
        # K identical deterministic tenants interleave evenly instead of
        # colliding on the same instants (a pure shift — burstiness and
        # rate are untouched); tenant 0 keeps t=0, so a single-tenant
        # composition is bit-identical to its source's own timeline
        rate = t.arrival.mean_rate()
        if k and rate > 0:
            ts = ts + (k / len(tenants)) / rate
        a_parts.append(a.astype(np.uint32))
        w_parts.append(np.asarray(w, bool))
        l_parts.append(np.asarray(l, np.int32))
        tid_parts.append(np.full(n_t, k, np.int32))
        ts_parts.append(np.asarray(ts, np.float64))
        seq_parts.append(np.arange(n_t, dtype=np.int64))

    # Activity windows: each tenant's natural span (at its own arrival
    # rate) stretched over its window fraction implies a total stream
    # span; the max over tenants is the span every window fits into.
    # Shifting a tenant's clock by window_start * span moves it into its
    # window without touching its rate or burstiness; tenants whose
    # natural span is shorter than their window simply depart early.
    # All-default windows shift by zero — the composition is bit-
    # identical to a window-free one.
    if any(t.window != (0.0, 1.0) for t in tenants):
        spans = [float(ts[-1] - ts[0]) if len(ts) > 1 else 0.0
                 for ts in ts_parts]
        total_span = max((s / w for s, w in zip(spans, widths) if w > 0),
                         default=0.0)
        for k, t in enumerate(tenants):
            if t.window[0] > 0.0:
                ts_parts[k] = ts_parts[k] + t.window[0] * total_span

    addrs = np.concatenate(a_parts)
    writes = np.concatenate(w_parts)
    levels = np.concatenate(l_parts)
    tid = np.concatenate(tid_parts)
    ts = np.concatenate(ts_parts)
    seq = np.concatenate(seq_parts)
    # merge by arrival time; deterministic tie-break (tenant, then that
    # tenant's own sequence) so equal timestamps never reorder randomly
    order = np.lexsort((seq, tid, ts))
    return Workload(tenants, addrs[order], writes[order], levels[order],
                    tid[order], ts[order], n_cores=n_cores, seed=seed)


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _parse_window(seg: str) -> Optional[Tuple[float, float]]:
    """``"0.3:0.8"`` / ``"0.3:"`` / ``":0.6"`` -> (start, end) fractions,
    or None when the segment is not a window spec (e.g. an arrival spec,
    whose kind prefix is alphabetic)."""
    head, colon, tail = seg.partition(":")
    if not colon:
        return None
    head, tail = head.strip(), tail.strip()
    if (head and not _is_number(head)) or (tail and not _is_number(tail)):
        return None
    if not head and not tail:
        return None
    return (float(head) if head else 0.0, float(tail) if tail else 1.0)


def make_workload(spec: str, *, length: int, n_cores: int,
                  arrival: str = "det:2e6", seed: int = 0,
                  ws_scale: float = 1.0) -> Workload:
    """Build a Workload from CLI-style specs.

    ``spec`` is a comma-separated tenant list; each tenant is
    ``source[*weight][@arrival][@window]`` — the source uses the registry
    syntax (``workloads/sources.py``), ``weight`` defaults to 1, a
    per-tenant ``@arrival`` overrides the shared ``arrival`` spec, and a
    numeric ``@start:end`` segment is an *activity window* (fractions of
    the stream's wall-clock span; either side may be omitted).  Examples:

      "cfd"                                   one tenant, shared arrival
      "cfd,kmeans*2"                          kmeans gets 2/3 of requests
      "cfd@det:2e6,kmeans@onoff:8e6,1e-3,3e-3"  per-tenant arrivals
      "cfd@0:0.6,kmeans@0.3:"                 cfd departs at 60%, kmeans
                                              arrives at 30% (churn)

    A window segment is told apart from an arrival by its numeric-only
    ``start:end`` shape (arrival kinds are alphabetic); both may be given
    (``cfd@poisson:2e6@0:0.5``).  Commas both separate tenants and appear
    inside mmpp/onoff arrival arguments; a comma-segment whose leading
    ``@``-free prefix parses as a bare number is therefore glued back
    onto the previous tenant's spec.
    """
    parts: List[str] = []
    for seg in (s.strip() for s in spec.split(",") if s.strip()):
        if parts and _is_number(seg.partition("@")[0]):
            parts[-1] += "," + seg
        else:
            parts.append(seg)
    tenants = []
    for k, part in enumerate(parts):
        chunks = part.split("@")
        name_part, star, weight_part = chunks[0].partition("*")
        weight = float(weight_part) if star else 1.0
        arr_part: Optional[str] = None
        window: Optional[Tuple[float, float]] = None
        for seg in chunks[1:]:
            win = _parse_window(seg.strip())
            if win is not None:
                assert window is None, \
                    f"tenant {name_part!r}: two activity windows in {part!r}"
                window = win
            else:
                assert arr_part is None, \
                    f"tenant {name_part!r}: two arrival specs in {part!r}"
                arr_part = seg.strip()
        window = window if window is not None else (0.0, 1.0)
        source = src.make_source(name_part.strip())
        proc = arr.make_arrival(arr_part if arr_part else arrival)
        tenants.append(Tenant(name=f"t{k}:{name_part.strip()}",
                              source=source, arrival=proc, weight=weight,
                              window=window))
    assert tenants, f"empty workload spec {spec!r}"
    return compose(tenants, length=length, n_cores=n_cores, seed=seed,
                   ws_scale=ws_scale)


# ------------------------------------------------------- Stats attribution

def hit_rate(stats) -> float:
    """LLC hit rate of a Stats record (same formula as cache_sim)."""
    hits = float(np.asarray(stats.conv_hits) + np.asarray(stats.ext_hits))
    total = hits + float(np.asarray(stats.conv_misses)
                         + np.asarray(stats.ext_true_miss))
    return hits / max(total, 1.0)


def attribute_stats(cfg, workload: Workload, *, warmup: int = 0,
                    device=None):
    """Exact per-tenant Stats of one full replay of ``workload``.

    Runs the composed stream once per tenant with that tenant's count
    mask, batched into a single engine dispatch (B = K identical request
    streams whose masks differ).  Because every replay applies identical
    requests in identical order, the cache state evolves identically and
    each request is counted by exactly one tenant: the returned per-tenant
    Stats sum to the global Stats bit-identically on integer counters.
    ``device=None`` runs on the CUDA card; ``device="cpu"`` runs the
    scans' plain versions.

    Returns {tenant name -> Stats (numpy scalar leaves)}.
    """
    from ..core import engine
    from ..core.controller import Stats

    dev = engine.resolve_device(device)
    masks = workload.tenant_masks()
    traces = [(workload.addrs, workload.writes, workload.levels, warmup)
              for _ in masks]
    pt = engine.pack(cfg, traces, count=masks)
    stats_b, _ = engine._run_packed(cfg, engine.to_device(pt, dev))
    host = [x.cpu().numpy() for x in stats_b]
    return {t.name: Stats(*[x[k] for x in host])
            for k, t in enumerate(workload.tenants)}
