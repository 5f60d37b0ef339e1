"""Rank bodies of ``tests/test_torch_distributed.py``: what each process of
a ``gloo`` world on the CPU runs (``repro_torch.distributed.world.spawn``).

This module imports only numpy, torch and ``repro_torch``, so a spawned
rank never imports JAX; every body checks ``sys.modules`` for ``jax``
and ``repro`` at its end.  The reference's values are computed in the
pytest process and reach the ranks as numpy; the ranks return numpy and
the port's own result objects.
"""
import dataclasses
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import configs
from repro_torch.checkpoint import latest, restore_on_mesh, save
from repro_torch.data import shard_batch
from repro_torch.distributed import context, sharding, world
from repro_torch.launch.mesh import (make_dev_mesh, make_fleet_mesh,
                                     make_production_mesh)
from repro_torch.models import LM, moe, params_from_numpy
from repro_torch.models.weights import param_tree
from repro_torch.pytree import flatten
from repro_torch.runtime import fleet, governor
from repro_torch.train import train_step
from repro_torch.train.loop import train
from repro_torch.workloads import serving


def no_jax() -> None:
    bad = [m for m in ("jax", "repro") if m in sys.modules]
    assert not bad, f"rank {world.rank()} imported {bad}"


def cpu_mesh(shape):
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def fleet_specs(rows, **kw):
    return [fleet.ReplicaSpec(app, system, length=length, seed=seed, **kw)
            for app, system, length, seed in rows]


def fleet_runs(cases: dict, sizes) -> dict:
    """``simulate_fleet`` of each case over a fleet axis of each size (the
    ranks past the axis take no part and return nothing for it)."""
    out = {}
    for n in sizes:
        mesh = make_fleet_mesh(n)          # a collective: every rank
        if mesh.get_coordinate() is None:
            continue
        for name, (rows, kw) in cases.items():
            out[(name, n)] = fleet.simulate_fleet(
                fleet_specs(rows, **kw), device="cpu", mesh=mesh)
    return out


def governors_run() -> list:
    """``evaluate_governors`` of two governor configs over a fleet axis of
    the whole world (``tests/test_torch_fleet.py``'s case)."""
    gcfgs = [governor.SERVING_GCFG, governor.gcfg_from_dict({"epsilon": 0.05})]
    return fleet.evaluate_governors(
        [serving.bursty_workload("cfd", "det:2e6", length=9_000)], gcfgs,
        target_epoch=3_000, candidates=[(32, 36), (48, 20)], device="cpu",
        mesh=make_fleet_mesh())


def moe_run(case: dict, shape) -> dict:
    """The MoE layer on a (data, model) mesh: this rank's tokens (its
    ``(pod, data)`` block of the flattened tokens, ``batch_spec``), its
    experts' shards; the output and the gradients of ``sum(y ** 2)``,
    and the output with the mesh installed with ``global_batch``."""
    cfg = dataclasses.replace(configs.get(case["arch"]).reduced(),
                              capacity_factor=case["capacity_factor"])
    mesh = cpu_mesh(shape)
    p = case["params"]
    x = torch.from_numpy(case["x"])
    x = sharding.local_shard(x, sharding.batch_spec(mesh, x.shape[0]),
                             mesh).clone().requires_grad_(True)
    local = {k: torch.from_numpy(p[k]) for k in ("router",)}
    for k in ("w_gate", "w_up", "w_down"):
        local[k] = sharding.local_shard(torch.from_numpy(p[k]),
                                        ("model", None, None), mesh).clone()
    local["shared"] = {k: torch.from_numpy(v)
                       for k, v in p["shared"].items()}
    leaves = [local["router"], local["w_gate"], local["w_up"],
              local["w_down"]] + [local["shared"][k]
                                  for k in sorted(local["shared"])]
    for t in leaves:
        t.requires_grad_(True)
    with context.use_mesh(mesh):
        y = moe.moe_mlp(local, x, cfg)
    grads = torch.autograd.grad((y ** 2).sum(), leaves + [x])
    with torch.no_grad(), context.use_mesh(mesh, global_batch=True):
        y_global = moe.moe_mlp(local, x, cfg)
    return {"coord": sharding.coordinate(mesh),
            "y": y.detach().numpy(), "y_global": y_global.numpy(),
            "grads": [g.numpy() for g in grads]}


def batch_rows(batches: list, shape) -> list:
    mesh = cpu_mesh(shape)
    return [{k: v.numpy() for k, v in shard_batch(b, mesh,
                                                  device="cpu").items()}
            for b in batches]


def train_run(case: dict, shape) -> dict:
    """``train`` over a (data, model) mesh from the reference's weights."""
    cfg = configs.get(case["arch"]).reduced()
    mesh = make_dev_mesh(shape[1])
    assert tuple(mesh.shape) == tuple(shape)
    state, losses, _ = train(cfg, steps=case["steps"], batch=case["batch"],
                             seq=case["seq"], seed=0, mesh=mesh,
                             device="cpu", init=case["init"],
                             print_fn=lambda *_: None)
    return {"losses": losses,
            "params": {n: leaf.numpy() for n, leaf in flatten(state.params)}}


def train_restart(rank: int, case: dict, ckpt_dir: str, fault: bool
                  ) -> dict:
    """``train`` on (2, 1) with a checkpoint every step in ``ckpt_dir``
    (resuming from one there); with ``fault``, rank 1's second step
    raises before its collectives, while rank 0 goes on into them."""
    if fault:
        make = train_step.make_train_step

        def make_faulty(*a, **kw):
            step, calls = make(*a, **kw), []

            def faulty(state, batch):
                calls.append(1)
                if rank == 1 and len(calls) == 2:
                    raise RuntimeError("planted fault")
                return step(state, batch)
            return faulty
        train_step.make_train_step = make_faulty
    cfg = configs.get(case["arch"]).reduced()
    state, losses, rep = train(cfg, steps=case["steps"], batch=case["batch"],
                               seq=case["seq"], seed=0, mesh=make_dev_mesh(1),
                               device="cpu", init=case["init"],
                               ckpt_dir=ckpt_dir, ckpt_every=1,
                               print_fn=lambda *_: None)
    no_jax()
    return {"losses": losses, "report": dataclasses.asdict(rep),
            "params": {n: leaf.numpy() for n, leaf in flatten(state.params)}}


def elastic_run(case: dict, ckpt_dir: str) -> dict:
    """Rank 0 writes a checkpoint of the model; every rank restores it on
    a (2, 2) mesh and returns its shards."""
    cfg = configs.get(case["arch"]).reduced()
    mesh = cpu_mesh((2, 2))
    if world.rank() == 0:
        model = LM(cfg, device="cpu")
        params_from_numpy(model, case["init"])
        save(ckpt_dir, 7, param_tree(model))
    world.barrier()
    step, shards = restore_on_mesh(latest(ckpt_dir),
                                   param_tree(LM(cfg, device="cpu")), mesh)
    return {"step": step, "coord": sharding.coordinate(mesh),
            "shards": {n: leaf.numpy() for n, leaf in flatten(shards)}}


def production_mesh_error() -> str:
    try:
        make_production_mesh()
    except ValueError as e:
        return str(e)
    return ""


def world4(rank: int, payload: dict) -> dict:
    """Every check of the world of 4 ranks, in one world."""
    out = {"fleet": fleet_runs(payload["fleet"], (1, 4)),
           "governors": governors_run(),
           "production": production_mesh_error(),
           "moe": {(name, shape): moe_run(case, shape)
                   for name, case in payload["moe"].items()
                   for shape in payload["moe_meshes"]},
           "batch": {shape: batch_rows(payload["batches"], shape)
                     for shape in payload["moe_meshes"]},
           "train": {arch: train_run(case, (2, 2))
                     for arch, case in payload["train"].items()},
           "elastic": elastic_run(payload["elastic"], payload["ckpt_dir"]),
           "rank": dist.get_rank()}
    no_jax()
    return out


def world2(rank: int, payload: dict) -> dict:
    """The fleet over a fleet axis of the whole world of 2, data-parallel
    training on (2, 1)."""
    out = {"fleet": fleet_runs(payload["fleet"], (2,)),
           "train": {arch: train_run(case, (2, 1))
                     for arch, case in payload["train"].items()}}
    no_jax()
    return out


def fail_on(rank: int, bad: int) -> int:
    if rank == bad:
        raise ValueError(f"rank {rank} fails")
    return rank


def hang_on(rank: int, bad: int) -> int:
    if rank == bad:
        time.sleep(600)
    return rank
