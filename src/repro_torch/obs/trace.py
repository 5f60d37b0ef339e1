"""Lightweight nestable spans exporting Chrome/Perfetto trace-event JSON
(a copy of ``repro.obs.trace``, with the span records below added).

A ``Tracer`` collects complete ("ph": "X") events from ``span(...)``
context managers and instant ("ph": "i") events from ``instant(...)``;
``to_chrome()``/``save()`` render the standard trace-event envelope that
``chrome://tracing`` and https://ui.perfetto.dev load directly.  Nesting
needs no explicit parent links in the export — the viewer reconstructs
the stack from (ts, dur) containment per (pid, tid) track, and thread ids
are mapped to small stable ints in first-seen order.

Beside the Chrome events, and not in them, the tracer keeps one
``SpanRecord`` a closed span (``Tracer.records``): its start and end in
integer ns of the clock, an id, and the id of the span open around it on
the same thread (its parent), so a reader can walk the span tree without
the viewer's containment rule.  ``span(...).on_device(device)`` also
records the span's device edges where ``device`` is a CUDA device: a CUDA
event on the device's current stream at enter and at exit, resolved to
device milliseconds only when the record is read
(``SpanRecord.device_ms``), so a span of work the host only enqueues
times the device's share of it without waiting inside the span.

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

import itertools
import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional


def _default_clock() -> int:
    return time.perf_counter_ns()


class SpanRecord(NamedTuple):
    """One closed span as ``Tracer.records`` keeps it: integer ns of the
    tracer's clock, its id, its parent's id (None for a span opened
    with no other open on its thread), its tags (the Chrome event's
    ``args``), and its device edges (a CUDA event pair, or None)."""
    name: str
    t0: int
    t1: int
    id: int
    parent: Optional[int]
    tags: Dict
    edges: Optional[tuple] = None

    def device_ms(self) -> Optional[float]:
        """Device ms between the span's edges on its stream, None without
        edges.  Waits for the exit edge: read after the work is done."""
        if self.edges is None:
            return None
        e0, e1 = self.edges
        e1.synchronize()
        return e0.elapsed_time(e1)


def _cuda_edge(device):
    """A timing CUDA event recorded on ``device``'s current stream."""
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """One live span; ``set(**tags)`` injects tags learned mid-span
    (e.g. ``handoff`` only knows its flush count at the end);
    ``on_device(device)`` asks for device edges before it is entered."""

    __slots__ = ("_tracer", "name", "tags", "_t0", "_id", "_parent",
                 "_stack", "_device", "_e0")

    def __init__(self, tracer: "Tracer", name: str, tags: Dict):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self._t0 = 0
        self._device = None

    def set(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def on_device(self, device) -> "Span":
        """Record device edges where ``device`` (a ``torch.device``) is a
        CUDA device; any other device records none."""
        if getattr(device, "type", None) == "cuda":
            self._device = device
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        self._stack = stack = tr._stack()
        self._id = i = next(tr._ids)
        self._parent = stack[-1] if stack else None
        stack.append(i)
        self._t0 = tr._clock()
        if self._device is not None:
            self._e0 = _cuda_edge(self._device)
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        t1 = tr._clock()
        edges = None
        if self._device is not None:
            edges = (self._e0, _cuda_edge(self._device))
        self._stack.pop()
        args = tr._complete(self.name, self._t0, t1, self.tags)
        # flat, one object fewer a span for the garbage collector to walk;
        # one extend is GIL-atomic, so two threads' fields never interleave
        tr._fields.extend((self.name, self._t0, t1, self._id, self._parent,
                           args, edges))
        return False


class _NullSpan:
    """The disabled path: accepts the whole Span surface, does nothing."""

    __slots__ = ()

    def set(self, **tags) -> "_NullSpan":
        return self

    def on_device(self, device) -> "_NullSpan":
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
        self._fields: list = []      # SpanRecord fields, span after span
        self._tids: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open = threading.local()

    @property
    def records(self) -> List[SpanRecord]:
        """The closed spans, in the order they closed."""
        f, n = self._fields, len(SpanRecord._fields)
        return [SpanRecord(*f[i:i + n]) for i in range(0, len(f), n)]

    def _stack(self) -> List[int]:
        """The ids of this thread's open spans, innermost last."""
        stack = getattr(self._open, "ids", None)
        if stack is None:
            stack = self._open.ids = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def span(self, name: str, **tags) -> Span:
        return Span(self, name, tags)

    def _complete(self, name: str, t0: int, t1: int, tags: Dict) -> Dict:
        """Append the span's Chrome event; returns its ``args``."""
        args = dict(tags)
        self.events.append({
            "name": name, "ph": "X", "ts": t0 / 1e3,
            "dur": max(t1 - t0, 0) / 1e3,
            "pid": 0, "tid": self._tid(), "args": args})
        return args

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
