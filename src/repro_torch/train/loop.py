"""End-to-end training loop, after ``repro.train.loop``: data pipeline +
train step + supervisor, on the CUDA card unless ``device="cpu"``.

With a mesh (``launch.mesh.make_dev_mesh`` over a world of ranks, every
rank calling ``train`` alike) it trains data-parallel: each rank draws
the same weights and reads the same pipeline, takes its rows of each
batch (``data.shard_batch``), and the step averages the gradients and
the loss over the batch shards (``train_step._mesh_reduce``) before the
compressor, so every rank takes the same AdamW step and reports the
global loss.  The mesh is installed for the step
(``distributed.context``).  The reference's layers see the
global batch (its ``train`` installs no mesh), so with its rows cut
over the batch axes the mesh goes in with ``global_batch``: an MoE
layer takes its capacity and queue places over the whole batch
(``models.moe``), and the drops are the reference's.  The mesh's first
rank alone prints and writes the checkpoints; a failed step on a mesh of
more than one rank is re-raised for the launcher to restart the world
(``distributed.fault_tolerance``).

With a ``model`` axis of more than one rank it trains tensor-parallel:
the model is built on ``meta`` and placed on the mesh
(``distributed.tensor_parallel.distribute_model``, each rank drawing each
leaf from the same generator and keeping its shard), every rank feeds
the whole batch (each keeps its rows), and the step runs on DTensors
(``train_step``), AdamW's moments placed by ``opt_state_specs``.  Its
checkpoints are the one-device layout, gathered leaf by leaf; a resumed
rank keeps its block of each leaf."""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from ..data import make_pipeline, shard_batch
from ..distributed import context as dist_ctx
from ..distributed import tensor_parallel as tp
from ..distributed import world
from ..distributed.sharding import axis_sizes
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
    dev = resolve_device(device)
    parallel = mesh is not None and axis_sizes(mesh).get("model", 1) > 1
    opt = AdamW(learning_rate=lr,
                schedule=cosine_with_warmup(min(20, steps // 10 + 1), steps))
    comp = Int8Compressor() if grad_compression else None
    if init is None:
        init = torch.Generator(device=dev).manual_seed(seed)
    if parallel:
        model = tp.distribute_model(build_model(cfg, device="meta"), mesh,
                                    init, device=dev)
        state = TS.init_state(model, opt, compressor=comp)
    else:
        model = build_model(cfg, device=dev)
        state = TS.init_state(model, opt, init, compressor=comp)
    step = TS.make_train_step(model, opt, microbatches=microbatches,
                              compressor=comp, mesh=mesh)

    pipe = make_pipeline(cfg.vocab_size, batch, seq, seed=seed)

    losses = []

    def wrapped(state, np_batch):
        if parallel:            # the whole batch: each rank keeps its rows
            state, metrics = step(state, shard_batch(np_batch, device=dev))
        else:
            b = shard_batch(np_batch, mesh, device=dev)
            cut = any(b[k].shape[0] < v.shape[0]
                      for k, v in np_batch.items())
            with dist_ctx.use_mesh(mesh, global_batch=cut):
                state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        if len(losses) % log_every == 0 and world.is_first(mesh):
            print_fn(f"step {len(losses):5d} loss {losses[-1]:.4f}")
        return state, metrics

    if ckpt_dir:
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=ckpt_dir,
                                               ckpt_every=ckpt_every),
                              mesh=mesh)
        state, rep = sup.run(wrapped, state, pipe, num_steps=steps)
        return state, losses, rep
    for i, np_batch in zip(range(steps), pipe):
        state, _ = wrapped(state, np_batch)
    return state, losses, SupervisorReport(steps_run=steps,
                                           last_loss=losses[-1])
