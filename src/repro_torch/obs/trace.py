"""Lightweight nestable spans exporting Chrome/Perfetto trace-event JSON
(a copy of ``repro.obs.trace``).

A ``Tracer`` collects complete ("ph": "X") events from ``span(...)``
context managers and instant ("ph": "i") events from ``instant(...)``;
``to_chrome()``/``save()`` render the standard trace-event envelope that
``chrome://tracing`` and https://ui.perfetto.dev load directly.  Nesting
needs no explicit parent links — the viewer reconstructs the stack from
(ts, dur) containment per (pid, tid) track, and thread ids are mapped to
small stable ints in first-seen order.

The clock is injectable (``Tracer(clock=...)``, monotonic nanoseconds):
tests drive a counting clock so exported traces are byte-deterministic,
and nothing else in the repo's deterministic artifacts (trajectory
JSONL, telemetry CSV) ever touches a timestamp — the tracer is the only
place wall-clock time is allowed to appear.

When tracing is disabled, instrumentation sites get ``NULL_SPAN`` — one
shared do-nothing context manager — from ``obs.span``, so a disabled
span costs one dict build and one identity return (docs/observability.md
budgets the total at <=2%, gated in CI).
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional


def _default_clock() -> int:
    return time.perf_counter_ns()


class Span:
    """One live span; ``set(**tags)`` injects tags learned mid-span
    (e.g. ``handoff`` only knows its flush count at the end)."""

    __slots__ = ("_tracer", "name", "tags", "_t0")

    def __init__(self, tracer: "Tracer", name: str, tags: Dict):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self._t0 = 0

    def set(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def __enter__(self) -> "Span":
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._complete(self.name, self._t0, self._tracer._clock(),
                               self.tags)
        return False


class _NullSpan:
    """The disabled path: accepts the whole Span surface, does nothing."""

    __slots__ = ()

    def set(self, **tags) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: shared singleton — ``obs.span`` returns this when tracing is off, so
#: the disabled fast path allocates nothing per call
NULL_SPAN = _NullSpan()


class Tracer:
    """Collects trace events; thread-safe via the GIL-atomic list append
    (one tracer is shared by every instrumented site in the process)."""

    def __init__(self, clock: Optional[Callable[[], int]] = None):
        self._clock = clock if clock is not None else _default_clock
        self.events: List[Dict] = []
        self._tids: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def span(self, name: str, **tags) -> Span:
        return Span(self, name, tags)

    def _complete(self, name: str, t0: int, t1: int, tags: Dict) -> None:
        self.events.append({
            "name": name, "ph": "X", "ts": t0 / 1e3,
            "dur": max(t1 - t0, 0) / 1e3,
            "pid": 0, "tid": self._tid(), "args": dict(tags)})

    def instant(self, name: str, **args) -> None:
        self.events.append({
            "name": name, "ph": "i", "s": "g", "ts": self._clock() / 1e3,
            "pid": 0, "tid": self._tid(), "args": dict(args)})

    # ------------------------------------------------------------- export
    def to_chrome(self) -> Dict:
        """The trace-event envelope (ts/dur in microseconds)."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        # default=str: span tags may carry numpy scalars or tuples from
        # instrumentation sites; a trace export must never raise
        return json.dumps(self.to_chrome(), indent=1, default=str) + "\n"

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    def summary(self) -> Dict[str, Dict]:
        """Per span name: {count, total_us, mean_us, max_us} — the
        timeline aggregate ``tools/obs_report.py`` renders."""
        out: Dict[str, Dict] = {}
        for e in self.events:
            if e["ph"] != "X":
                continue
            s = out.setdefault(e["name"],
                               {"count": 0, "total_us": 0.0, "max_us": 0.0})
            s["count"] += 1
            s["total_us"] += e["dur"]
            s["max_us"] = max(s["max_us"], e["dur"])
        for s in out.values():
            s["mean_us"] = s["total_us"] / s["count"]
        return out
