"""The reference's GSPMD lowering of small cells on a (2, 2) mesh of host
devices, for ``tests/test_torch_tensor_parallel.py``: the shardings of
``repro.launch.dryrun.lower_cell`` (``param_shardings``,
``opt_state_specs``, ``batch_spec``, ``cache_shardings``) on
``jax.make_mesh((2, 2), ("data", "model"))`` with Auto axes,
``jit(...).lower().compile()`` and ``hlo_cost.analyze`` of the
per-device program.

Run in a process of its own (the host-device count is fixed at JAX's
start), with the cases as JSON on the command line:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_gspmd_ref.py \\
        '[["qwen3-4b", "prefill", 4, 16, null]]'

and prints one JSON list of {"flops", "collective_by_kind"} per case.
With ``moe IN.npz OUT.npz`` instead, on a host platform of 3 devices, it
runs the reference's ``moe_mlp`` under a (1, 3) mesh (whose ``model``
axis does not divide 8 experts: ``_moe_mlp_dense``, the expert stacks
replicated by ``param_specs``) on IN's ``x`` and the layer's leaves
(``p/<path>``), and writes the output ``y`` to OUT.
A case is (arch, kind, global batch, sequence, heads): ``heads`` None
keeps the reduced config's heads, else (num_heads, num_kv_heads) replaces
them.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import configs
from repro.configs.shapes import ShapeConfig
from repro.distributed import context as dist_ctx
from repro.distributed import sharding as shd
from repro.launch import specs as S
from repro.models import build_model
from repro.optim import AdamW, AdamWState
from repro.roofline import hlo_cost
from repro.train import TrainState, make_train_step


def config(arch, heads):
    cfg = configs.get(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    return cfg


def named(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def batch_shardings(shape, mesh, batch):
    """``repro.launch.dryrun._batch_shardings``."""
    out = {}
    for k, v in batch.items():
        if k == "positions":
            ok = shape.global_batch % shd.batch_axis_size(mesh) == 0
            out[k] = NamedSharding(mesh, P(None, shd.batch_axes(mesh)
                                           if ok else None, None))
        elif k == "cur_pos":
            out[k] = NamedSharding(mesh, P())
        else:
            out[k] = NamedSharding(mesh, shd.batch_spec(
                mesh, shape.global_batch, len(v.shape)))
    return out


def lower(mesh, arch, kind, b, s, heads):
    """``lower_cell``'s lowering of one cell on ``mesh``; the per-device
    cost."""
    cfg = config(arch, heads)
    shape = ShapeConfig("cell", s, b, kind)
    dist_ctx.set_mesh(mesh)
    model = build_model(cfg)
    params = S.abstract_params(model)
    p_sh = shd.param_shardings(params, mesh)
    batch = S.input_specs(cfg, shape)
    with mesh:
        if kind == "train":
            opt = AdamW(moment_dtype=jnp.float32)
            opt_abs = jax.eval_shape(opt.init, params)
            mu = shd.opt_state_specs(params, mesh)
            o_sh = AdamWState(step=NamedSharding(mesh, P()),
                              mu=named(mesh, mu), nu=named(mesh, mu))
            step = make_train_step(model, opt)
            lowered = jax.jit(step, in_shardings=(
                TrainState(params=p_sh, opt=o_sh, comp=None),
                batch_shardings(shape, mesh, batch))).lower(
                TrainState(params=params, opt=opt_abs, comp=None), batch)
        elif kind == "prefill":
            caches = S.abstract_caches(model, shape)
            c_sh = shd.cache_shardings(cfg, caches, mesh, b)
            lowered = jax.jit(
                lambda p, x, c: model.prefill(p, x, c),
                in_shardings=(p_sh, batch_shardings(shape, mesh, batch),
                              c_sh)).lower(params, batch, caches)
        else:
            caches = S.abstract_caches(model, shape)
            c_sh = shd.cache_shardings(cfg, caches, mesh, b)
            lowered = jax.jit(
                lambda p, t, c, pos: model.decode_step(p, t, c, pos),
                in_shardings=(p_sh, NamedSharding(
                    mesh, shd.batch_spec(mesh, b, 1)), c_sh,
                    NamedSharding(mesh, P()))).lower(
                params, batch["tokens"], caches, batch["cur_pos"])
        text = lowered.compile().as_text()
    dist_ctx.set_mesh(None)
    cost = hlo_cost.analyze(text)
    return {"flops": float(cost.flops),
            "collective_by_kind": {k: int(v) for k, v in
                                   cost.collective_by_kind.items()}}


def main(cases):
    # Auto axes: GSPMD partitions what the shardings leave open (JAX 0.9's
    # make_mesh defaults to Explicit axes, under which the reference's
    # with_sharding_constraint and its sharded contractions refuse to
    # lower)
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
    return [lower(mesh, *c) for c in cases]


def moe_layer(src: str, dst: str, arch: str = "deepseek-moe-16b"):
    import numpy as np
    from repro.models import moe
    data = dict(np.load(src))
    p = {}
    for key, v in data.items():
        if key.startswith("p/"):
            *path, leaf = key[2:].split("/")
            d = p
            for k in path:
                d = d.setdefault(k, {})
            d[leaf] = jnp.asarray(v)
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((1, 3), ("data", "model"), axis_types=(auto, auto))
    cfg = configs.get(arch).reduced()
    dist_ctx.set_mesh(mesh)
    with mesh:
        p = jax.device_put(p, named(mesh, shd.param_specs(p, mesh)))
        y = jax.jit(lambda p, x: moe.moe_mlp(p, x, cfg))(
            p, jnp.asarray(data["x"]))
    dist_ctx.set_mesh(None)
    np.savez(dst, y=np.asarray(y))


if __name__ == "__main__":
    if sys.argv[1] == "moe":
        moe_layer(*sys.argv[2:])
    else:
        print(json.dumps(main(json.loads(sys.argv[1]))))
