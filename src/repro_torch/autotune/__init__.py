"""Design-space autotuner over the batched engine, after
``repro.autotune``.

ArchGym-style search layer: ``space`` declares typed knob spaces with
decoders onto ``cache_sim.RunPoint`` overrides (hardware design points)
and ``GovernorConfig`` (governor hyperparameters); ``agents`` are
pluggable proposal strategies (random walk / hill climb with restarts /
GA) behind a two-method protocol; ``objectives`` score a whole
generation as ONE batched dispatch (``run_batch`` sweep or
``evaluate_governors`` fleet run); ``tuner`` drives the loop with
byte-deterministic JSONL trajectories, resume-from-trajectory, and
``best_configs.json`` artifacts.  See docs/autotune.md.  ``space``,
``agents`` and ``tuner`` are numpy only and copied; the objectives run
the port's engine on ``device``.
"""
from .agents import (AGENTS, Genetic, HillClimb,  # noqa: F401
                     RandomWalk, SearchAgent, make_agent)
from .objectives import GovernorObjective, HardwareObjective  # noqa: F401
from .space import (Knob, SearchSpace, gov_space,  # noqa: F401
                    hw_space, to_gcfg, to_run_points)
from .tuner import (Generation, TrajectoryError, Tuner,  # noqa: F401
                    TunerResult, read_trajectory, replay_agent,
                    trajectory_crc, write_best_configs)
