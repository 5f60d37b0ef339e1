"""Online Morpheus runtime of the PyTorch port, after ``repro.runtime``:
the layer between the batch simulator and the serving stack.

  * ``stream``    — epoch-by-epoch resumable replay over an explicit
    ``EngineState`` carry (the engine's stateful scans, once an epoch),
    the device ring of pre-packed epochs, state files, and the
    warm-state handoff used when the mode split changes;
  * ``governor``  — the adaptive mode-split governor (hill-climb /
    epsilon-greedy over the offline policy's candidate splits, with
    hysteresis and phase-shift detection), ``simulate_online``, and the
    serving pool's ``ServingGovernor``;
  * ``telemetry`` — the per-epoch ring-buffer log with JSON/CSV export.

Not ported yet: the reference's ``fleet`` and ``admission`` modules.
"""
from .governor import (SERVING_GCFG, Governor,  # noqa: F401
                       GovernorConfig, GovernorState, OnlineReplica,
                       OnlineResult, ServingGovernor,
                       candidates_for, demo_pool, describe_tick,
                       gcfg_from_dict, qos_reward, simulate_online,
                       tenant_epoch_costs, tenant_epoch_ipcs)
from .stream import EpochStream, HandoffReport, handoff  # noqa: F401
from .telemetry import (EpochRecord, TelemetryLog,  # noqa: F401
                        merge_logs)
