"""Workload subsystem of the PyTorch port (numpy only, after
``repro.workloads``): every way a request stream can be produced.

  * ``synthetic`` — the Table-2 parameterized per-app generators;
  * ``corpus``    — file-backed ``.npz`` trace corpus (import / export /
    validate);
  * ``sources``   — the pluggable ``TraceSource`` protocol + registry;
  * ``arrivals``  — arrival processes that timestamp requests and chunk
    them into variable-size epochs;
  * ``tenancy``   — the multi-tenant composer producing the ``Workload``
    the online runtime (``runtime/stream.py``, ``runtime/governor.py``)
    replays;
  * ``serving``, ``overload`` — serving-side round sizes, SLO budgeters
    and overload scenarios.

This ``__init__`` is lazy (PEP 562), as the reference's: ``core/traces.py``
imports ``workloads.synthetic`` at module level, so eagerly importing the
composer here (which reaches the engine, which reaches ``core``) would
create an import cycle.
"""
from __future__ import annotations

_EXPORTS = {
    # synthetic
    "AppSpec": "synthetic", "WORKLOADS": "synthetic",
    "MEMORY_BOUND": "synthetic", "COMPUTE_BOUND": "synthetic",
    "generate": "synthetic", "generate_phased": "synthetic",
    # sources
    "TraceSource": "sources", "SyntheticSource": "sources",
    "PhasedSource": "sources", "CorpusSource": "sources",
    "make_source": "sources", "register_source": "sources",
    "SOURCE_KINDS": "sources",
    # corpus
    "save_trace": "corpus", "load_trace": "corpus",
    "validate_trace": "corpus", "trace_info": "corpus",
    # arrivals
    "ArrivalProcess": "arrivals", "Deterministic": "arrivals",
    "Poisson": "arrivals", "MMPP": "arrivals", "make_arrival": "arrivals",
    "empirical_rate": "arrivals", "burstiness": "arrivals",
    "epochs_by_time": "arrivals",
    # tenancy
    "Tenant": "tenancy", "Workload": "tenancy", "compose": "tenancy",
    "make_workload": "tenancy", "attribute_stats": "tenancy",
    "hit_rate": "tenancy", "TENANT_STRIDE_BLOCKS": "tenancy",
    # serving-side helpers
    "round_sizes": "serving", "tenant_prompts": "serving",
    "round_requests": "serving", "SLOBudgeter": "serving",
    "slo_batches": "serving", "batch_mix": "serving",
    "bursty_workload": "serving",
    "TenantSLO": "serving", "TenantSLOBudgeter": "serving",
    "tenant_slo_batches": "serving",
    "apportion_largest_remainder": "serving",
    "proportional_interleave": "serving",
    # overload scenarios
    "LoadScenario": "overload", "SHAPES": "overload",
    "demand_schedule": "overload", "offered_totals": "overload",
    "SCENARIOS": "overload",
}

_SUBMODULES = ("arrivals", "corpus", "overload", "serving", "sources",
               "synthetic", "tenancy")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name: str):
    import importlib
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
