"""Unified observability: spans, metrics, and decision provenance (the
port's copy of ``repro.obs``, with the same public names).

Zero-overhead-when-disabled instrumentation for the whole runtime
(docs/observability.md).  Three side channels, all strictly additive —
enabling them changes no simulator number, no governor decision, no
deterministic artifact byte (tests/test_obs.py pins bit-identity):

  * ``trace``    — nestable spans -> Chrome/Perfetto trace-event JSON
    (``obs.span("stream.step", ...)``; null-object fast path when off);
  * ``metrics``  — process-global counters/gauges/histograms with
    Prometheus text + JSON snapshot export, including a build probe
    counting the port's ``nvcc`` kernel builds (``kernels/_build.py``);
  * ``decision`` — structured ``DecisionEvent`` provenance for every
    governor decision path (always recorded — pure bookkeeping — and
    additionally emitted as trace instant events when tracing is on).

Activation: ``obs.enable()`` (both), ``obs.enable(trace=False)``
(counters only — what the bench tools use, cheap enough to keep on), or
environment ``REPRO_OBS=1`` at import.  ``obs.disable()`` drops both;
the tracer/registry objects stay readable by whoever holds them.

This package imports nothing from the rest of ``repro_torch`` (and
neither ``jax`` nor ``repro``), so every layer — core, runtime,
workloads, serving, kernels — can instrument itself without cycles.
"""
from __future__ import annotations

import os
from typing import Optional

from . import inspect as _inspect
from . import metrics as _metrics
from .decision import (ADMISSION_KINDS, TRIGGERS,  # noqa: F401
                       AdmissionEvent, DecisionEvent)
from .inspect import Inspector, Snapshot  # noqa: F401
from .metrics import (Registry, admission_counters,  # noqa: F401
                      bench_counters, count, observe, set_gauge)
from .trace import NULL_SPAN, Span, Tracer  # noqa: F401

_TRACER: Optional[Tracer] = None


def enable(*, trace: bool = True, metrics: bool = True,
           clock=None, inspect: bool = False,
           inspect_every: int = 1) -> None:
    """Activate observability (idempotent: live collectors are kept).

    ``inspect=True`` additionally installs the cache-content inspector
    (``obs.inspect``): decoded per-epoch state snapshots, strided
    by ``inspect_every``.  Off by default — snapshot decoding is host
    work the regular span/metric probes never pay."""
    global _TRACER
    if trace and _TRACER is None:
        _TRACER = Tracer(clock=clock)
    if metrics:
        _metrics.activate()
    if inspect and _inspect.active() is None:
        _inspect.activate(Inspector(every=inspect_every))


def disable() -> None:
    global _TRACER
    _TRACER = None
    _metrics.deactivate()
    _inspect.deactivate()


def enabled() -> bool:
    return (_TRACER is not None or _metrics.active() is not None
            or _inspect.active() is not None)


def tracing() -> bool:
    return _TRACER is not None


def metrics_on() -> bool:
    """Guard for sites whose metric *value* costs something to compute
    (e.g. summing device_get byte counts over a pytree)."""
    return _metrics.active() is not None


def tracer() -> Optional[Tracer]:
    return _TRACER


def metrics_registry() -> Optional[Registry]:
    return _metrics.active()


def inspector() -> Optional[Inspector]:
    """The active cache-content inspector, or None (the one None-check
    every introspection site pays when the microscope is off)."""
    return _inspect.active()


def span(name: str, **tags):
    """A span on the active tracer, or the shared no-op when disabled."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, **tags)


def instant(name: str, **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, **args)


if os.environ.get("REPRO_OBS", "") not in ("", "0"):
    enable()
