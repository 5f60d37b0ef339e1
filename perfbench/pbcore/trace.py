"""What a traced run reads: the benchmark's own spans around the calls
into the program's layers, and the device trace of ``torch.profiler``.

``Spans`` wraps a call (a method of the program's object, as an
attribute of that object; the program is not edited) so that each call
is timed on the host clock, synchronised before and after where the
device's work must be inside the time.  In a traced window it also keeps
each call's interval on the wall clock (``time.time_ns``, the clock the
profiler's events carry), so an idle gap of the device can be named by
what the host was doing.

``DeviceTrace`` profiles the device alone (CUDA activity; no host op is
recorded, so the profiled calls run as they do untraced), and reduces
the kernels to: busy seconds (the union of their intervals), the traced
window, device time by kernel name, and the idle gaps by host span.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch


def syncer(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


class Spans:
    """Host time by span name (seconds, calls), and while ``keep`` is set
    every interval on the wall clock."""

    def __init__(self, device: torch.device):
        self.sync = syncer(device)
        self.total: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.keep = False
        self.intervals: List[Tuple[str, int, int]] = []
        self._wrapped: List[Tuple[object, str]] = []

    def reset(self) -> None:
        self.total.clear()
        self.calls.clear()

    def wrap(self, obj, attr: str, name: str, sync: bool = True) -> None:
        """Time ``obj.attr(...)`` as span ``name`` from now on."""
        fn = getattr(obj, attr)

        def call(*a, **k):
            if sync:
                self.sync()
            w0, t0 = time.time_ns(), time.perf_counter()
            out = fn(*a, **k)
            if sync:
                self.sync()
            self.total[name] += time.perf_counter() - t0
            self.calls[name] += 1
            if self.keep:
                self.intervals.append((name, w0, time.time_ns()))
            return out
        setattr(obj, attr, call)
        self._wrapped.append((obj, attr))

    def mark(self, name: str, w0: int, w1: int) -> None:
        if self.keep:
            self.intervals.append((name, w0, w1))

    def unwrap(self) -> None:
        for obj, attr in reversed(self._wrapped):
            try:
                delattr(obj, attr)
            except AttributeError:
                pass
        self._wrapped.clear()


class DeviceTrace:
    """A profiled window of the device.  ``start``/``stop`` bracket it;
    ``summary`` reduces it (None on a host with no CUDA device)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.host0 = self.host1 = 0
        self.anchor_ns: Optional[int] = None

    def start(self) -> None:
        if self.device.type != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.anchor_ns = time.time_ns()
        torch.cuda._sleep(1000)        # a marker kernel on the idle card
        torch.cuda.synchronize()
        self.host0 = time.time_ns()

    def stop(self) -> None:
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.host1 = time.time_ns()
        self.prof.stop()

    def _events(self) -> List[Tuple[str, int, int]]:
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
        return out

    def summary(self, intervals: List[Tuple[str, int, int]]
                ) -> Optional[dict]:
        """Busy and window seconds, device seconds by kernel name, the
        kernels as (name, start, end) ns, and the idle seconds of the
        window by the innermost host span covering each gap."""
        if self.prof is None:
            return None
        events = self._events()
        shift = 0
        marks = [e for e in events if "spin" in e[0].lower()]
        if marks and self.anchor_ns is not None:
            shift = marks[0][1] - self.anchor_ns
        lo, hi = self.host0 + shift, self.host1 + shift
        kern = sorted(((n, max(s, lo), min(t, hi)) for n, s, t in events
                       if t > lo and s < hi), key=lambda e: e[1])
        by_name: Dict[str, float] = defaultdict(float)
        busy, gaps, cur = 0, [], lo
        for n, s, t in kern:
            by_name[n] += (t - s) / 1e9
            if s > cur:
                gaps.append((cur, s))
            if t > cur:
                busy += t - max(s, cur)
                cur = t
        if hi > cur:
            gaps.append((cur, hi))
        by_span: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for n, s, t in intervals:
            by_span[n].append((s + shift, t + shift))
        for v in by_span.values():
            v.sort()
        starts = {n: [s for s, _ in v] for n, v in by_span.items()}
        idle: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid, best = (a + b) // 2, None
            for n, v in by_span.items():
                i = bisect.bisect_right(starts[n], mid) - 1
                if i >= 0 and v[i][1] >= mid and (
                        best is None or v[i][1] - v[i][0] < best[0]):
                    best = (v[i][1] - v[i][0], n)
            idle[best[1] if best else "between calls"] += (b - a) / 1e9
        return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
                "by_name": dict(by_name), "kernels": kern,
                "idle": dict(idle)}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_seconds(summary: Optional[dict], match: Callable[[str], bool]
                   ) -> Optional[float]:
    """Device seconds of the kernels whose name ``match``es; None where
    the trace holds none."""
    if not summary:
        return None
    t = sum(v for k, v in summary["by_name"].items() if match(k))
    return t if t > 0 else None


def launches(summary: Optional[dict], match: Callable[[str], bool]) -> int:
    if not summary:
        return 0
    return sum(1 for n, _, _ in summary["kernels"] if match(n))
