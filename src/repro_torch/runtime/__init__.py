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
  * ``telemetry`` — the per-epoch ring-buffer log with JSON/CSV export;
  * ``fleet``     — N replicas per engine call: same-config replicas'
    state rows concatenated into one batch (one stateful scan launch a
    group epoch on the card), with a shared split advisor for
    cross-replica warm starts;
  * ``admission`` — overload-aware admission control: shed or defer the
    lowest-priority tenants with aging when the per-tenant SLO budgeter
    says the joint SLO set is unattainable, and feed the pressure back
    into the governor.
"""
from .admission import (AdmissionConfig,  # noqa: F401
                        AdmissionController, OverloadResult, RoundPlan,
                        simulate_overload)
from .fleet import (FleetResult, ReplicaSpec,  # noqa: F401
                    SplitAdvisor, build_replicas, convergence_epoch,
                    evaluate_governors, run_serial, simulate_fleet)
from .governor import (SERVING_GCFG, Governor,  # noqa: F401
                       GovernorConfig, GovernorState, OnlineReplica,
                       OnlineResult, ServingGovernor,
                       candidates_for, demo_pool, describe_tick,
                       gcfg_from_dict, qos_reward, simulate_online,
                       tenant_epoch_costs, tenant_epoch_ipcs)
from .stream import EpochStream, HandoffReport, handoff  # noqa: F401
from .telemetry import (EpochRecord, TelemetryLog,  # noqa: F401
                        merge_logs)
