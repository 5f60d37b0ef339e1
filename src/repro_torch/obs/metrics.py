"""Process-global metrics registry: counters, gauges, histograms.

One ``Registry`` holds every metric of a run; exposition is dual:

  * ``to_prometheus()`` — the text format scrapers ingest (``# HELP`` /
    ``# TYPE`` / ``name{labels} value``); counters are exposed as
    monotone ``morpheus_<name>_total`` series, so rates (epochs/s,
    dispatches/s) are the scraper's ``rate()`` over them, never computed
    here from wall clock (exports stay timestamp-free);
  * ``snapshot()`` / ``save()`` — a JSON document for offline tooling
    (``tools/obs_report.py``, the bench counters in ``BENCH_*.json``).

Metric names are short canonical slugs ("engine_dispatches"); the
Prometheus renderer prefixes ``morpheus_`` and suffixes counters with
``_total``.  Module-level helpers (``count``/``set_gauge``/``observe``)
write to the *active* registry and are cheap no-ops when none is active
— instrumentation sites never need to know whether obs is on.

The build probe (the port's counterpart of the reference's
``jax.monitoring`` compile hook, which counts XLA compiles into
``jax_compiles``): every ``nvcc`` run of ``kernels/_build.py`` calls
``record_build``, which counts it into ``kernel_builds`` and its
seconds into ``kernel_build_seconds`` on the active registry.  A
library already built (same source hash) runs no ``nvcc`` and counts
nothing, so the counter is exactly "kernel libraries built".
``BENCH_COUNTER_KEYS["compiles"]`` names ``kernel_builds``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "morpheus_"

#: JSON snapshot schema version.  Versionless snapshots (pre-schema
#: exports) are read as version 1 by ``tools/obs_report.py``; an unknown
#: version is a hard reader error (exit 2), never a traceback.
SNAPSHOT_SCHEMA = 1

DEFAULT_BUCKETS = (1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotone float/int accumulator, one series per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.values: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        assert n >= 0, f"counter {self.name} cannot decrease"
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0) + n

    def total(self) -> float:
        return sum(self.values.values())

    def samples(self) -> List[Dict]:
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self.values.items())]

    def expose(self) -> List[str]:
        full = f"{PREFIX}{self.name}_total"
        out = [f"# HELP {full} {self.help}".rstrip(),
               f"# TYPE {full} counter"]
        for k, v in sorted(self.values.items()):
            out.append(f"{full}{_fmt_labels(k)} {v:g}")
        return out


class Gauge:
    """Last-write-wins instantaneous value per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.values: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels) -> None:
        self.values[_label_key(labels)] = float(v)

    def samples(self) -> List[Dict]:
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self.values.items())]

    def expose(self) -> List[str]:
        full = f"{PREFIX}{self.name}"
        out = [f"# HELP {full} {self.help}".rstrip(),
               f"# TYPE {full} gauge"]
        for k, v in sorted(self.values.items()):
            out.append(f"{full}{_fmt_labels(k)} {v:g}")
        return out


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations <= its bound, +Inf counts all)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # label key -> [per-finite-bucket counts..., count, sum]
        self.values: Dict[LabelKey, List[float]] = {}

    def observe(self, v: float, **labels) -> None:
        k = _label_key(labels)
        row = self.values.get(k)
        if row is None:
            row = self.values[k] = [0] * len(self.buckets) + [0, 0.0]
        for i, b in enumerate(self.buckets):
            if v <= b:
                row[i] += 1
        row[-2] += 1
        row[-1] += float(v)

    def samples(self) -> List[Dict]:
        out = []
        for k, row in sorted(self.values.items()):
            out.append({"labels": dict(k),
                        "buckets": {f"{b:g}": row[i]
                                    for i, b in enumerate(self.buckets)},
                        "count": row[-2], "sum": row[-1]})
        return out

    def expose(self) -> List[str]:
        full = f"{PREFIX}{self.name}"
        out = [f"# HELP {full} {self.help}".rstrip(),
               f"# TYPE {full} histogram"]
        for k, row in sorted(self.values.items()):
            for i, b in enumerate(self.buckets):
                le = 'le="%g"' % b
                out.append(f"{full}_bucket{_fmt_labels(k, le)} {row[i]:g}")
            inf = 'le="+Inf"'
            out.append(f"{full}_bucket{_fmt_labels(k, inf)} {row[-2]:g}")
            out.append(f"{full}_sum{_fmt_labels(k)} {row[-1]:g}")
            out.append(f"{full}_count{_fmt_labels(k)} {row[-2]:g}")
        return out


class Registry:
    """Get-or-create metric store; creation order is exposition order."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        assert isinstance(m, cls), \
            f"metric {name!r} already registered as {m.kind}"
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    # ------------------------------------------------------------- export
    def snapshot(self) -> Dict:
        return {"schema": SNAPSHOT_SCHEMA, "metrics": [
            {"name": m.name, "kind": m.kind, "help": m.help,
             "samples": m.samples()} for m in self._metrics.values()]}

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in self._metrics.values():
            lines.extend(m.expose())
        return "\n".join(lines) + "\n" if lines else ""

    def save(self, path) -> Path:
        """``.json`` suffix -> JSON snapshot; anything else -> the
        Prometheus text exposition."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix == ".json":
            path.write_text(json.dumps(self.snapshot(), indent=1,
                                       sort_keys=True) + "\n")
        else:
            path.write_text(self.to_prometheus())
        return path


# ------------------------------------------------- process-global helpers

_ACTIVE: Optional[Registry] = None


def activate(reg: Optional[Registry] = None) -> Registry:
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = reg if reg is not None else Registry()
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Registry]:
    return _ACTIVE


def count(name: str, n: float = 1, **labels) -> None:
    reg = _ACTIVE
    if reg is not None:
        reg.counter(name).inc(n, **labels)


def set_gauge(name: str, v: float, **labels) -> None:
    reg = _ACTIVE
    if reg is not None:
        reg.gauge(name).set(v, **labels)


def observe(name: str, v: float, **labels) -> None:
    reg = _ACTIVE
    if reg is not None:
        reg.histogram(name).observe(v, **labels)


# ----------------------------------------------------------- build probe

def record_build(seconds: float, **labels) -> None:
    """Count one ``nvcc`` build of a kernel source (``kernels/_build.py``
    calls this after each run of the compiler) on the active registry;
    a run with no active registry records nothing."""
    reg = _ACTIVE
    if reg is not None:
        reg.counter("kernel_builds",
                    "CUDA kernel libraries built by nvcc").inc(1, **labels)
        reg.counter("kernel_build_seconds",
                    "cumulative nvcc build time").inc(seconds, **labels)


# --------------------------------------------------------- bench counters

#: canonical counters the bench tools embed in ``BENCH_*.json`` v2
BENCH_COUNTER_KEYS = {
    "dispatches": "engine_dispatches",
    "compiles": "kernel_builds",
    "device_get_bytes": "device_get_bytes",
    "flush_writebacks": "flush_writebacks",
    "epochs": "epochs",
    "snapshots": "state_snapshots",
}


def bench_counters(reg: Optional[Registry] = None) -> Dict[str, float]:
    """Flat {key: total} over the canonical bench counters (0 for
    counters the run never touched) — ``tools/bench_schema.write_bench``
    embeds this verbatim."""
    reg = reg if reg is not None else _ACTIVE
    out: Dict[str, float] = {}
    for key, name in BENCH_COUNTER_KEYS.items():
        m = reg.get(name) if reg is not None else None
        v = m.total() if m is not None else 0
        out[key] = int(v) if float(v).is_integer() else float(v)
    return out


def admission_counters(reg: Optional[Registry] = None) -> Dict[str, int]:
    """Flat {kind: requests} over the admission-control taxonomy
    (``obs.decision.ADMISSION_KINDS``), read from the
    ``admission_requests`` counter's per-kind label sets; 0 for kinds the
    run never emitted.  Deliberately NOT part of ``BENCH_COUNTER_KEYS``:
    the committed ``BENCH_*.json`` baselines are schema-validated against
    that exact key set, so the QoS view is additive on the side."""
    reg = reg if reg is not None else _ACTIVE
    kinds = ("admit", "defer", "shed", "resume")
    out = {k: 0 for k in kinds}
    m = reg.get("admission_requests") if reg is not None else None
    if m is not None:
        for labels, v in m.values.items():
            kind = dict(labels).get("kind")
            if kind in out:
                out[kind] += int(v)
    return out
