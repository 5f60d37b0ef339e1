"""The Table-2 trace generators under their historical name
(``repro.core.traces``): a re-export of ``workloads.synthetic``."""
from __future__ import annotations

from ..workloads import synthetic as _syn
from ..workloads.synthetic import (  # noqa: F401
    BLOCK_BYTES, COMPUTE_BOUND, MEMORY_BOUND, MiB, WORKLOADS, AppSpec,
    Workload, generate, generate_phased, instructions_for, phase_bounds)
from . import compression as _comp

if ((_syn.HIGH, _syn.LOW, _syn.UNCOMP) != (_comp.HIGH, _comp.LOW, _comp.UNCOMP)
        or _syn.BLOCK_BYTES != _comp.BLOCK_BYTES):
    raise ImportError("BDI level codes of workloads.synthetic and "
                      "core.compression drifted apart")

__all__ = [
    "BLOCK_BYTES", "MiB", "AppSpec", "Workload", "WORKLOADS",
    "MEMORY_BOUND", "COMPUTE_BOUND", "generate", "generate_phased",
    "phase_bounds", "instructions_for",
]
