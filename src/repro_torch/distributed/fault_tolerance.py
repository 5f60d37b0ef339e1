"""Fault tolerance and straggler detection for the training loop, after
``repro.distributed.fault_tolerance`` (plain Python, copied):

  * **Checkpoint/restart**: the supervisor checkpoints every N steps and,
    on ANY exception from the step function, restores the latest
    checkpoint and continues, up to ``max_restarts``; then it re-raises.
    So a step that fails now and then is hidden by a later success: a
    caller that must see every fault checks ``restarts == 0``.
  * **Straggler detection**: per-step wall-time EMA; steps slower than
    ``straggler_factor x`` EMA are counted and passed to a callback.
  * **Heartbeat**: a monotone step/time file other processes can watch.

The reference's supervisor never calls its elastic pod-drop path
(``checkpoint.elastic``); nothing of it is missing here.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

from ..checkpoint import checkpointer as ckpt

Tree = Any


@dataclass
class SupervisorConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ema_alpha: float = 0.1
    heartbeat_path: Optional[str] = None


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    last_loss: float = float("nan")
    resumed_from: Optional[int] = None


class TrainSupervisor:
    """Wraps a (state, batch) -> (state, metrics) step with fault handling."""

    def __init__(self, cfg: SupervisorConfig,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.cfg = cfg
        self.on_straggler = on_straggler
        self._ema: Optional[float] = None

    def _heartbeat(self, step: int):
        if self.cfg.heartbeat_path:
            Path(self.cfg.heartbeat_path).write_text(
                json.dumps({"step": step, "time": time.time()}))

    def run(self, step_fn, state: Tree, batches, *, num_steps: int,
            start_step: int = 0) -> tuple[Tree, SupervisorReport]:
        rep = SupervisorReport()
        cfg = self.cfg

        # resume if a checkpoint exists
        last = ckpt.latest(cfg.ckpt_dir)
        step = start_step
        if last is not None:
            step, state = ckpt.restore(last, state)
            rep.resumed_from = step

        it = iter(batches)
        while step < num_steps:
            batch = next(it)
            t0 = time.perf_counter()
            try:
                state, metrics = step_fn(state, batch)
            except Exception:
                rep.restarts += 1
                if rep.restarts > cfg.max_restarts:
                    raise
                last = ckpt.latest(cfg.ckpt_dir)
                if last is not None:
                    step, state = ckpt.restore(last, state)
                continue
            dt = time.perf_counter() - t0

            if self._ema is None:
                self._ema = dt
            else:
                if dt > cfg.straggler_factor * self._ema:
                    rep.stragglers += 1
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                self._ema = ((1 - cfg.ema_alpha) * self._ema
                             + cfg.ema_alpha * dt)

            step += 1
            rep.steps_run += 1
            loss = metrics.get("loss")
            if loss is not None:
                rep.last_loss = float(loss)
            if step % cfg.ckpt_every == 0 or step == num_steps:
                ckpt.save(cfg.ckpt_dir, step, state)
            self._heartbeat(step)
        return state, rep
