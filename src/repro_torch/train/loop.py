"""End-to-end training loop, after ``repro.train.loop``: data pipeline +
train step + supervisor, on the CUDA card unless ``device="cpu"``."""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from ..data import make_pipeline, shard_batch
from ..distributed.fault_tolerance import (SupervisorConfig, SupervisorReport,
                                           TrainSupervisor)
from ..models import build_model
from ..optim import AdamW, Int8Compressor, cosine_with_warmup
from . import train_step as TS


def train(cfg: ArchConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, mesh=None, microbatches: int = 1,
          grad_compression: bool = False, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, seed: int = 0, log_every: int = 10,
          print_fn=print, device=None, init=None):
    """Train ``cfg`` for ``steps`` steps; returns (state, losses, report).
    The weights are drawn by ``LM.init_weights`` from a generator seeded
    with ``seed`` (the reference draws ``model.init(PRNGKey(seed))``,
    which the port cannot reproduce), or loaded from ``init``, the
    reference's parameter tree as numpy arrays."""
    if mesh is not None:
        raise NotImplementedError("train: a mesh needs more than one "
                                  "device (ROADMAP A8.4)")
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    opt = AdamW(learning_rate=lr,
                schedule=cosine_with_warmup(min(20, steps // 10 + 1), steps))
    comp = Int8Compressor() if grad_compression else None
    if init is None:
        init = torch.Generator(device=dev).manual_seed(seed)
    state = TS.init_state(model, opt, init, compressor=comp)
    step = TS.make_train_step(model, opt, microbatches=microbatches,
                              compressor=comp)

    pipe = make_pipeline(cfg.vocab_size, batch, seq, seed=seed)

    losses = []

    def wrapped(state, np_batch):
        b = shard_batch(np_batch, device=dev)
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        if len(losses) % log_every == 0:
            print_fn(f"step {len(losses):5d} loss {losses[-1]:.4f}")
        return state, metrics

    if ckpt_dir:
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=ckpt_dir,
                                               ckpt_every=ckpt_every))
        state, rep = sup.run(wrapped, state, pipe, num_steps=steps)
        return state, losses, rep
    for i, np_batch in zip(range(steps), pipe):
        state, _ = wrapped(state, np_batch)
    return state, losses, SupervisorReport(steps_run=steps,
                                           last_loss=losses[-1])
