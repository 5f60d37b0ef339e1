"""Rank bodies of ``tests/test_torch_tensor_parallel.py``: what each process
of a ``gloo`` world on the CPU runs (``repro_torch.distributed.world
.spawn``), and the per-chip counts on a ``fake`` group.

This module imports only numpy, torch and ``repro_torch``, so a spawned
rank never imports JAX; every body checks ``sys.modules`` for ``jax``
and ``repro`` at its end.  The reference's values are computed in the
pytest process; the ranks return numpy.
"""
import dataclasses
import sys

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import configs
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.distributed import sharding, tensor_parallel as tp
from repro_torch.kernels import attention as att
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import LM, moe, params_from_numpy
from repro_torch.models.weights import param_tree
from repro_torch.pytree import flatten, from_parts
from repro_torch.roofline import op_cost
from repro_torch.train.loop import train


def no_jax() -> list:
    return [m for m in ("jax", "repro") if m in sys.modules]


def config(arch: str, heads=None):
    """The reduced config of ``arch``, its (query, KV) heads replaced by
    ``heads`` when given (the same in both packages)."""
    cfg = configs.get(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    return cfg


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def serve(model, batch: dict, new: int, max_len: int) -> dict:
    """Forward logits, then prefill and ``new`` greedy decode steps: the
    tokens and every step's logits (each whole, on every rank)."""
    t = tensors(batch)
    out = {"forward": model(t).numpy()}
    t.pop("positions", None)            # prefill reads none
    b, s = batch["tokens"].shape
    caches = model.init_caches(b, max_len)
    logits, caches = model.prefill(t, caches)
    toks, steps = [logits.argmax(-1)], [logits.numpy()]
    for i in range(new):
        logits, caches = model.decode_step(toks[-1], caches, s + i)
        toks.append(logits.argmax(-1))
        steps.append(logits.numpy())
    out["tokens"] = torch.stack(toks).numpy()
    out["step_logits"] = np.stack(steps)
    return out


def loss_and_grads(model, batch: dict) -> dict:
    """The loss and every gradient leaf (whole: ``full_tensor``) by its
    path in the reference's tree, stacked as the reference stacks it."""
    model.requires_grad_(True)
    loss = model.loss(tensors(batch))
    leaves = [p for _, leaf in flatten(param_tree(model)) for p in leaf.parts]
    with model.mesh_context():
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else tp.grad_to_param(g, p)
              for g, p in zip(gs, leaves)]
        whole = [g.full_tensor() if tp.is_dtensor(g) else g for g in gs]
    loss = loss.detach()
    tree = from_parts(param_tree(model), [g.detach() for g in whole])
    return {"loss": float(loss.full_tensor() if tp.is_dtensor(loss)
                          else loss),
            "grads": {n: leaf.numpy() for n, leaf in flatten(tree)}}


def shards_are_local_params(model, tree: dict, mesh) -> bool:
    """Whether each DTensor parameter's local shard is its block of the
    same leaf under ``sharding.local_params`` (views of the whole tree)."""
    ref = LM(model.cfg, device="cpu")
    params_from_numpy(ref, tree)
    want = sharding.local_params(param_tree(ref), mesh)
    got = param_tree(model)
    for (_, w), (_, g) in zip(flatten(want), flatten(got)):
        for a, b in zip(w.parts, g.parts):
            if not torch.equal(a, b.to_local()):
                return False
    return True


def family_on_mesh(case: dict, mesh) -> dict:
    """One family of ``case`` on ``mesh``: the model placed from the
    case's numpy tree, served, and on ``case["grad_mesh"]``
    differentiated;
    the launches and plain runs of the attention wrappers."""
    cfg = config(case["arch"], case.get("heads"))
    model = tp.distribute_model(LM(cfg, device="meta"), mesh, case["tree"],
                                device="cpu")
    att.reset_launches()
    out = serve(model, case["batch"], case["new"], case["max_len"])
    out["shards_ok"] = shards_are_local_params(model, case["tree"], mesh)
    if "moe_x" in case:
        out["moe_y"] = moe_layer(model, case["moe_x"], mesh)
    if tuple(mesh.shape) == case.get("grad_mesh"):
        out.update(loss_and_grads(model, case["train"]))
    out["plain_runs"] = dict(att.plain_runs)
    return out


def moe_layer(model, x: np.ndarray, mesh) -> np.ndarray:
    """The first MoE layer of ``model`` on ``x`` (tokens, D), the tokens
    placed by ``batch_spec``; the output whole."""
    layer = next(lay for lay, s in zip(model.layers, model.specs)
                 if s.mlp == "moe")
    with torch.no_grad(), model.mesh_context():
        y = moe.moe_mlp(layer.mlp, tp.batch_input(torch.from_numpy(x), mesh),
                        model.cfg)
    return y.full_tensor().numpy()


def moe_layer_counts(arch: str, tokens: int, mp: int) -> tuple:
    """FLOPs of ``arch``'s first MoE layer on ``tokens`` rows: per chip of
    a (1, ``mp``) mesh of the ``fake`` group this process is rank 0 of,
    and on one device; both on ``meta``."""
    cfg = config(arch)
    x = torch.empty((tokens, cfg.d_model), device="meta")

    def layer_flops(model, xin):
        lay = next(m for m, s in zip(model.layers, model.specs)
                   if s.mlp == "moe")
        with model.mesh_context():
            return op_cost.analyze(moe.moe_mlp, lay.mlp, xin, cfg).flops
    mesh = make_dev_mesh(mp, device_type="cpu")
    placed = tp.distribute_model(LM(cfg, device="meta"), mesh,
                                 device="meta")
    return (layer_flops(placed, tp.batch_input(x, mesh)),
            layer_flops(LM(cfg, device="meta"), x))


def moe_fallback_counts(arch: str, tokens: int, mp: int) -> dict:
    """``moe_layer_counts`` and the per-chip count of a prefill cell of
    ``arch`` (batch 4, S 16) on the same (1, ``mp``) mesh."""
    mesh_flops, one_flops = moe_layer_counts(arch, tokens, mp)
    cell = count_on_mesh([(arch, "prefill", 4, 16, None)], mp)[0]
    return {"layer": mesh_flops, "layer_one": one_flops,
            "cell": cell["flops"]}


def train_resumed(case: dict, mesh, ckpt_dir: str) -> dict:
    """``train`` on ``mesh`` (tensor-parallel) with a checkpoint every
    step in ``ckpt_dir``: one step, then a second call that resumes from
    its checkpoint to ``case["steps"]``; the losses, the report and the
    parameters (gathered whole)."""
    cfg = config(case["arch"])
    kw = dict(batch=case["batch"], seq=case["seq"], seed=0, mesh=mesh,
              device="cpu", init=case["tree"], ckpt_every=1,
              ckpt_dir=ckpt_dir, print_fn=lambda *_: None)
    _, first, _ = train(cfg, steps=1, **kw)
    state, losses, rep = train(cfg, steps=case["steps"], **kw)
    return {"losses": first + losses, "resumed_from": rep.resumed_from,
            "steps_run": rep.steps_run,
            "params": {n: leaf.numpy() for n, leaf in flatten(state.params)}}


def world_families(rank: int, cases: list, ckpt=None) -> dict:
    """Every (case, mesh shape) of ``cases`` on this world: each case
    names its mesh shapes, all of this world's size.  Rank 0 returns the
    results whole; every rank returns its plain runs and whether its
    shards matched.  ``ckpt`` (a case, its mesh shape and a directory):
    ``train_resumed`` there."""
    meshes = {}
    out = {"rank": rank, "results": {}, "plain": {}, "shards_ok": True}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = init_device_mesh(
                "cpu", shape, mesh_dim_names=("data", "model"))
        return meshes[shape]
    for case in cases:
        for shape in case["meshes"]:
            r = family_on_mesh(case, mesh_of(shape))
            out["shards_ok"] &= r.pop("shards_ok")
            out["plain"][(case["name"], shape)] = r["plain_runs"]
            if rank == 0:
                out["results"][(case["name"], shape)] = r
    if ckpt is not None:
        case, shape, path = ckpt
        out["ckpt"] = train_resumed(case, mesh_of(shape), path)
    out["jax"] = no_jax()
    return out


def count_on_mesh(cases: list, mp: int = 2) -> list:
    """Per-chip counts of ``cases`` (arch, kind, batch, seq, heads) on a
    (ranks / ``mp``, ``mp``) mesh of the ``fake`` group this process is
    rank 0 of ((2, 2) in a group of 4): the model placed on ``meta`` by
    tensor parallelism, the step counted by the op counter
    (``launch.dryrun.count_cell``)."""
    mesh = make_dev_mesh(mp, device_type="cpu")
    out = []
    for arch, kind, b, s, heads in cases:
        cfg = config(arch, heads)
        model = tp.distribute_model(LM(cfg, device="meta"), mesh,
                                    device="meta")
        cost = D.count_cell(cfg, ShapeConfig("cell", s, b, kind),
                            model=model)
        out.append({"flops": cost.flops, "by_name": cost.by_name,
                    "collective_by_kind": cost.collective_by_kind,
                    "argument_bytes": cost.argument_bytes})
    return out


def replicated_step_refused() -> str:
    """``make_train_step`` on a (1, 4) mesh of the ``fake`` group this
    process is rank 0 of, for a model that tensor parallelism did not
    place: the error it raises (empty if none)."""
    from repro_torch.optim import AdamW
    from repro_torch.train.train_step import make_train_step
    mesh = make_dev_mesh(4, device_type="cpu")
    try:
        make_train_step(LM(config("qwen3-4b"), device="cpu"), AdamW(),
                        mesh=mesh)
    except ValueError as e:
        return str(e)
    return ""


def count_twice(arch: str, shape: str) -> tuple:
    """The FLOPs and bytes of one production cell counted twice on the
    pod's fake group (DTensor's sharding propagation caches what it runs
    on global shapes the first time)."""
    first = D.lower_cell(arch, shape, multi_pod=False)
    second = D.lower_cell(arch, shape, multi_pod=False)
    return ((first["hlo_flops_per_chip"], first["hlo_bytes_per_chip"]),
            (second["hlo_flops_per_chip"], second["hlo_bytes_per_chip"]))


def mlp_cost(d: int, f: int, b: int) -> dict:
    """The count of a column- then row-parallel MLP (``layers.dense_mlp``)
    on a (1, 4) mesh of the fake group this process is rank 0 of."""
    from repro_torch.models import layers as L
    from repro_torch.roofline import op_cost
    mesh = make_dev_mesh(4, device_type="cpu")
    meta = torch.device("meta")
    spec = {"w_gate": (None, "model"), "w_up": (None, "model"),
            "w_down": ("model", None)}
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    p = {k: tp.shard_input(torch.empty(shapes[k], device=meta), mesh,
                           spec[k]) for k in spec}
    x = tp.batch_input(torch.empty((b, d), device=meta), mesh)
    one = {k: torch.empty(shapes[k], device=meta) for k in spec}
    with tp.implicit_replication():
        sharded = op_cost.analyze(lambda: L.dense_mlp(p, x, "silu"))
    whole = op_cost.analyze(lambda: L.dense_mlp(
        one, torch.empty((b, d), device=meta), "silu"))
    return {"sharded": (sharded.flops, sharded.collective_by_kind,
                        sharded.collective_counts),
            "whole": whole.flops}
