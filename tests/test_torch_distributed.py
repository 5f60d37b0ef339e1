"""The port's multi-device paths on ``gloo`` worlds of spawned CPU ranks
(``repro_torch.distributed.world.spawn``) against the reference's
one-device runs.

Two worlds, each started once for the module, both at once: 4 ranks
(the fleet over a ``fleet`` axis of 1 rank, a subset of the world, and
of 4, ``evaluate_governors``, the MoE layer expert-parallel on (1, 4),
(2, 2) and (4, 1), ``shard_batch``, data-parallel training on (2, 2),
``restore_on_mesh`` on (2, 2)) and 2 ranks (the fleet over a fleet axis
of 2, training on (2, 1)).  After the first of them, two more worlds
of 2 train on (2, 1) with checkpoints, one after the other: the first
with a fault planted on rank 1, the second resuming from rank 0's
checkpoint.  The
rank bodies live in
``tests/torch_dist_ranks.py``, which imports no JAX; the reference's
values are computed here and handed to the ranks as numpy.

Bounds: the fleet's integer Stats and decisions identical to the
reference's, ``ipc`` and rewards within 1e-3 of the reference's (the
engine's float contract) and 1e-9 of the port's one-process fleet; the
MoE output within 1e-5 of the reference's per-chip sum of
``_dispatch_compute`` plus the shared experts (with ``global_batch``,
of its ``_moe_mlp_dense`` over every token), its gradients within
5e-4 of ``jax.grad`` through the reference's ``shard_map`` on a 1 x 1
mesh and of the port's one-process autograd; training losses within
1e-5 and parameters after 3 steps within 1e-4
(``test_torch_train.assert_params_close``) of the reference's
``train(mesh=...)`` on a 1 x 1 mesh, and the resumed training within the
same bounds of the port's one-process run that resumes alike; the
elastic shards bit-identical to the reference's
restored leaves cut by its own specs.
"""
import dataclasses
import re
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.checkpoint import elastic as j_elastic  # noqa: E402
from repro.distributed import context as j_ctx  # noqa: E402
from repro.distributed import sharding as j_shd  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.runtime import fleet as j_fleet  # noqa: E402
from repro.runtime import governor as j_gov  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro.workloads import serving as j_serv  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.checkpoint import latest as t_latest  # noqa: E402
from repro_torch.data import shard_batch  # noqa: E402
from repro_torch.distributed import world  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.pytree import flatten as t_flatten  # noqa: E402
from repro_torch.runtime import fleet as t_fleet  # noqa: E402
from repro_torch.train import loop as t_loop  # noqa: E402
from repro_torch.runtime import governor as t_gov  # noqa: E402
from repro_torch.workloads import serving as t_serv  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
from test_torch_fleet import MIXED, SPECS4, assert_replica_equal  # noqa: E402
from test_torch_train import assert_params_close, ref_paths  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

FLEET = {"n4": (SPECS4, {"epoch_len": 2_000}),
         "mixed": (MIXED, {"epoch_len": 2_000})}
FLEET_SIZES = (1, 2, 4)
FLEET_WORLD = {1: 4, 2: 2, 4: 4}     # the world each axis runs in (1: a subset)
MOE_MESHES = ((1, 4), (2, 2), (4, 1))
MOE = {"dropless": ("deepseek-v2-lite-16b", 0.0),
       "capacity": ("deepseek-moe-16b", 0.5)}
MOE_TOKENS = 64
# deepseek-v2-lite is dropless, deepseek-moe-16b drops past its capacity
# factor of 1.25 (over the whole batch, as the reference's layer does)
TRAIN_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b", "deepseek-moe-16b")
TRAIN = dict(steps=3, batch=4, seq=16)
RESTART = dict(TRAIN, arch="qwen3-4b")
LR = 3e-4                                   # train()'s default
ELASTIC_ARCH = "deepseek-moe-16b"


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def ref_init(arch) -> dict:
    """The reference ``train``'s weights: ``init(PRNGKey(0))``."""
    return np_tree(j_build(j_configs.get(arch).reduced()).init(
        jax.random.PRNGKey(0)))


def moe_cfgs(name):
    arch, cf = MOE[name]
    return (dataclasses.replace(j_configs.get(arch).reduced(),
                                capacity_factor=cf),
            dataclasses.replace(t_configs.get(arch).reduced(),
                                capacity_factor=cf))


def moe_case(name) -> dict:
    jcfg, _ = moe_cfgs(name)
    p = np_tree(j_moe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32))
    x = np.random.default_rng(4).standard_normal(
        (MOE_TOKENS, jcfg.d_model)).astype(np.float32)
    return {"arch": MOE[name][0], "capacity_factor": MOE[name][1],
            "params": p, "x": x}


BATCHES = [{"tokens": np.arange(4 * 8, dtype=np.int32).reshape(4, 8),
            "frames": np.arange(4 * 3 * 2, dtype=np.float32
                                ).reshape(4, 3, 2)},
           {"tokens": np.arange(3 * 5, dtype=np.int32).reshape(3, 5)},
           {"tokens": np.arange(6, dtype=np.int32).reshape(1, 6)}]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic"))


@pytest.fixture(scope="module")
def moe_cases():
    return {name: moe_case(name) for name in MOE}


@pytest.fixture(scope="module")
def inits():
    return {arch: ref_init(arch) for arch in set(TRAIN_ARCHS)
            | {ELASTIC_ARCH}}


def restart_worlds(case: dict, ckpt_dir: str) -> dict:
    """A world of 2 training on (2, 1) whose rank 1 fails on its second
    step, then a new world that resumes from the checkpoint left."""
    t0 = time.monotonic()
    try:
        world.spawn(R.train_restart, 2, case, ckpt_dir, True, device="cpu",
                    timeout_s=120)
        error = None
    except RuntimeError as e:
        error = str(e)
    fault_s = time.monotonic() - t0
    left = t_latest(ckpt_dir).name
    return {"error": error, "fault_s": fault_s, "left": left,
            "ranks": world.spawn(R.train_restart, 2, case, ckpt_dir, False,
                                 device="cpu", timeout_s=300)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, ckpt_dir, moe_cases, inits):
    """The worlds, on two threads (each waits on its ranks), so the
    reference's values are computed here meanwhile: the restart's worlds
    start when the first thread is free, so no more than six ranks run
    at once."""
    train = {a: dict(TRAIN, arch=a, init=inits[a]) for a in TRAIN_ARCHS}
    payload4 = {"fleet": FLEET, "moe": moe_cases, "moe_meshes": MOE_MESHES,
                "batches": BATCHES, "train": train,
                "elastic": {"arch": ELASTIC_ARCH,
                            "init": inits[ELASTIC_ARCH]},
                "ckpt_dir": ckpt_dir}
    with ThreadPoolExecutor(2) as pool:
        yield {4: pool.submit(world.spawn, R.world4, 4, payload4,
                              device="cpu", timeout_s=300),
               2: pool.submit(world.spawn, R.world2, 2,
                              {"train": train, "fleet": FLEET},
                              device="cpu", timeout_s=300),
               "restart": pool.submit(
                   restart_worlds, dict(RESTART, init=inits["qwen3-4b"]),
                   str(tmp_path_factory.mktemp("restart")))}


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4].result()


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2].result()


# ------------------------------------------------------------------ fleet

@pytest.fixture(scope="module")
def fleet_refs():
    out = {}
    for name, (rows, kw) in FLEET.items():
        specs = [j_fleet.ReplicaSpec(a, s, length=n, seed=sd, **kw)
                 for a, s, n, sd in rows]
        one = t_fleet.simulate_fleet(R.fleet_specs(rows, **kw), device="cpu")
        out[name] = (j_fleet.simulate_fleet(specs, backend="jnp"), one)
    return out


@pytest.mark.parametrize("n", FLEET_SIZES)
@pytest.mark.parametrize("case", list(FLEET))
def test_fleet_over_a_fleet_axis_equals_the_reference(worlds, fleet_refs,
                                                      case, n):
    ref, one = fleet_refs[case]         # computed while the worlds run
    ws = worlds[FLEET_WORLD[n]].result()
    ranks = [w["fleet"][(case, n)] for w in ws[:n]]
    assert all((case, n) not in w["fleet"] for w in ws[n:])
    for r, fr in enumerate(ranks):
        assert fr.mesh_devices == n
        assert (fr.epochs, fr.dispatches) == (ref.epochs, ref.dispatches)
        assert fr.names == ref.names
        for i, (a, b, c) in enumerate(zip(ref.results, one.results,
                                          fr.results)):
            assert_replica_equal(a, c, 1e-3, f"rank {r} replica {i}")
            assert_replica_equal(b, c, 1e-9, f"rank {r} one-process {i}")


def test_evaluate_governors_over_a_fleet_axis(world4):
    j_gcfgs = [j_gov.SERVING_GCFG, j_gov.gcfg_from_dict({"epsilon": 0.05})]
    ref = j_fleet.evaluate_governors(
        [j_serv.bursty_workload("cfd", "det:2e6", length=9_000)], j_gcfgs,
        target_epoch=3_000, candidates=[(32, 36), (48, 20)], backend="jnp")
    one = t_fleet.evaluate_governors(
        [t_serv.bursty_workload("cfd", "det:2e6", length=9_000)],
        [t_gov.SERVING_GCFG, t_gov.gcfg_from_dict({"epsilon": 0.05})],
        target_epoch=3_000, candidates=[(32, 36), (48, 20)], device="cpu")
    for w in world4:
        got = w["governors"]
        for k in range(2):
            assert_replica_equal(ref[k][0], got[k][0], 1e-3, f"gcfg {k}")
            assert_replica_equal(one[k][0], got[k][0], 1e-9, f"gcfg {k}")


def test_fleet_axis_outside_a_world_raises():
    mesh = types.SimpleNamespace(shape={"fleet": 2})
    with pytest.raises(RuntimeError, match="initialised world"):
        t_fleet.simulate_fleet(R.fleet_specs(SPECS4[:1]), device="cpu",
                               mesh=mesh)


# -------------------------------------------------------------------- MoE

def ref_per_chip(case: dict, name: str, shape) -> list:
    """The reference's ``_moe_mlp_shardmap`` per data shard, as its
    chips compute it: each model chip's ``_dispatch_compute`` of its
    experts on the shard's tokens, summed, plus the shared experts."""
    jcfg, _ = moe_cfgs(name)
    nd, nm = shape
    p, x = case["params"], case["x"]
    el = jcfg.num_experts // nm
    n = MOE_TOKENS // nd
    out = []
    for d in range(nd):
        xs = jnp.asarray(x[d * n:(d + 1) * n])
        gates = jax.nn.softmax(xs @ p["router"], axis=-1)
        y = sum(j_moe._dispatch_compute(
            {k: p[k][m * el:(m + 1) * el] for k in
             ("w_gate", "w_up", "w_down")}, xs, gates, jcfg, m * el, el)
            for m in range(nm))
        y = y + j_layers.dense_mlp(p["shared"], xs, jcfg.act)
        out.append(np.asarray(y))
    return out


@pytest.mark.parametrize("shape", MOE_MESHES)
@pytest.mark.parametrize("name", list(MOE))
def test_moe_expert_parallel_equals_the_references_chips(world4, moe_cases,
                                                         name, shape):
    want = ref_per_chip(moe_cases[name], name, shape)
    for w in world4:
        got = w["moe"][(name, shape)]
        d = got["coord"]["data"]
        np.testing.assert_allclose(got["y"], want[d], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", MOE_MESHES)
@pytest.mark.parametrize("name", list(MOE))
def test_moe_global_batch_drops_as_the_references_dense_layer(
        world4, moe_cases, name, shape):
    """With ``global_batch`` (data-parallel training) every rank's rows
    equal its block of the reference's ``_moe_mlp_dense`` over all the
    tokens, which the reference's ``train(mesh=...)`` runs: the capacity
    and queue places of the whole batch, on every mesh."""
    case = moe_cases[name]
    jcfg, _ = moe_cfgs(name)
    dense = np.asarray(j_moe._moe_mlp_dense(case["params"], case["x"], jcfg))
    n = MOE_TOKENS // shape[0]
    for w in world4:
        got = w["moe"][(name, shape)]
        d = got["coord"]["data"]
        np.testing.assert_allclose(got["y_global"], dense[d * n:(d + 1) * n],
                                   rtol=1e-5, atol=1e-5)


def test_moe_capacity_is_taken_per_data_shard(world4, moe_cases):
    """With a capacity factor the drops follow the data shard (the
    reference's per-chip ``_capacity`` over its local tokens): on (1, 4)
    the output is the one-process layer's, on (2, 2) and (4, 1) it is
    not."""
    case = moe_cases["capacity"]
    jcfg, tcfg = moe_cfgs("capacity")
    dense = np.asarray(j_moe._moe_mlp_dense(case["params"], case["x"], jcfg))
    for shape in MOE_MESHES:
        ys = {w["moe"][("capacity", shape)]["coord"]["data"]:
              w["moe"][("capacity", shape)]["y"] for w in world4}
        y = np.concatenate([ys[d] for d in sorted(ys)])
        gap = np.abs(y - dense).max()
        if shape[0] == 1:
            assert gap <= 1e-5, shape
        else:
            assert gap > 1e-2, shape


def grads_of_ranks(world4, name, shape, e):
    """The layer's gradients summed as the train step sums them: the
    router's over every rank, each expert slice's over its data shards,
    the shared experts' over the data shards of model rank 0, the
    input's rows from model rank 0 of each data shard."""
    nd, nm = shape
    el = e // nm
    rs = [w["moe"][(name, shape)] for w in world4]
    router = sum(r["grads"][0] for r in rs)
    experts = [np.concatenate([sum(r["grads"][i] for r in rs
                                   if r["coord"]["model"] == m)
                               for m in range(nm)]) for i in (1, 2, 3)]
    n_shared = len(rs[0]["grads"]) - 5
    m0 = sorted((r for r in rs if r["coord"]["model"] == 0),
                key=lambda r: r["coord"]["data"])
    shared = [sum(r["grads"][4 + i] for r in m0) for i in range(n_shared)]
    x = np.concatenate([r["grads"][-1] for r in m0])
    for r in rs:                     # model ranks agree on the input's
        twin = m0[r["coord"]["data"]]
        np.testing.assert_allclose(r["grads"][-1], twin["grads"][-1],
                                   rtol=1e-6, atol=1e-6)
    return [router] + experts + shared + [x]


def one_process_grads(case, tcfg) -> list:
    p = case["params"]
    leaves = [torch.tensor(p[k], requires_grad=True)
              for k in ("router", "w_gate", "w_up", "w_down")]
    shared = {k: torch.tensor(v, requires_grad=True)
              for k, v in p["shared"].items()}
    x = torch.tensor(case["x"], requires_grad=True)
    tp = dict(zip(("router", "w_gate", "w_up", "w_down"), leaves),
              shared=shared)
    y = t_moe.moe_mlp(tp, x, tcfg)
    ins = leaves + [shared[k] for k in sorted(shared)] + [x]
    return [g.numpy() for g in torch.autograd.grad((y ** 2).sum(), ins)]


def ref_shardmap_grads(case, jcfg) -> list:
    p = jax.tree.map(jnp.asarray, case["params"])
    mesh = jax.make_mesh((1, 1), ("data", "model"))

    def loss(p, x):
        with j_ctx.use_mesh(mesh):
            return jnp.sum(j_moe.moe_mlp(p, x, jcfg) ** 2)

    with mesh:
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            p, jnp.asarray(case["x"]))
    return [np.asarray(gp[k]) for k in ("router", "w_gate", "w_up",
                                        "w_down")] + \
        [np.asarray(gp["shared"][k]) for k in sorted(gp["shared"])] + \
        [np.asarray(gx)]


@pytest.mark.parametrize("name,shape", [("dropless", s) for s in MOE_MESHES]
                         + [("capacity", (1, 4))])
def test_moe_expert_parallel_gradients(world4, moe_cases, name, shape):
    """Every expert slice, the router, the shared experts and the input,
    against ``jax.grad`` through the reference's ``shard_map`` (1 x 1) and
    the port's one-process autograd: where the drops are those of the
    whole batch (dropless, or one data shard)."""
    case = moe_cases[name]
    jcfg, tcfg = moe_cfgs(name)
    got = grads_of_ranks(world4, name, shape, tcfg.num_experts)
    for want in (ref_shardmap_grads(case, jcfg),
                 one_process_grads(case, tcfg)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4,
                                       err_msg=f"gradient {i}")


@pytest.mark.parametrize("name", list(MOE))
def test_aux_load_balance_loss_equals_the_reference(moe_cases, name):
    case = moe_cases[name]
    jcfg, tcfg = moe_cfgs(name)
    want = float(j_moe.aux_load_balance_loss(case["params"], case["x"], jcfg))
    got = float(t_moe.aux_load_balance_loss(
        {"router": torch.tensor(case["params"]["router"])},
        torch.tensor(case["x"]), tcfg))
    assert abs(got - want) <= 1e-6


def test_expert_parallel_needs_a_dividing_model_axis():
    cfg = t_configs.get("deepseek-moe-16b").reduced()       # 8 experts
    assert t_moe.expert_parallel(cfg, {"data": 2, "model": 4})
    assert t_moe.expert_parallel(cfg, {"model": 1})
    assert not t_moe.expert_parallel(cfg, {"data": 4})
    assert not t_moe.expert_parallel(cfg, {"model": 3})
    assert not t_moe.expert_parallel(cfg, None)


# ------------------------------------------------------------ shard_batch

@pytest.mark.parametrize("shape", MOE_MESHES)
def test_shard_batch_rows_follow_the_references_batch_spec(world4, shape):
    duck = types.SimpleNamespace(shape={"data": shape[0],
                                        "model": shape[1]})
    for w in world4:
        d = w["moe"][("dropless", shape)]["coord"]["data"]
        for b, got in zip(BATCHES, w["batch"][shape]):
            assert got.keys() == b.keys()
            for k, v in b.items():
                spec = j_shd.batch_spec(duck, v.shape[0], v.ndim)
                if spec[0] is None:
                    want = v
                else:
                    n = v.shape[0] // shape[0]
                    want = v[d * n:(d + 1) * n]
                np.testing.assert_array_equal(got[k], want)


def test_shard_batch_without_a_device_mesh_raises():
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_batch(BATCHES[0], mesh={"data": 2}, device="cpu")


# -------------------------------------------------------------- training

@pytest.fixture(scope="module")
def train_refs():
    """The reference's ``train(mesh=...)`` on a 1 x 1 mesh: its layers see
    the whole batch.  The mesh's axes are automatic: on explicit axes
    (``jax.make_mesh``'s default in this JAX) the reference's gather of
    a sharded batch raises."""
    out = {}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    for arch in TRAIN_ARCHS:
        state, losses, _ = j_loop.train(j_configs.get(arch).reduced(),
                                        seed=0, print_fn=lambda *_: None,
                                        mesh=mesh, **TRAIN)
        out[arch] = (losses, ref_paths(state.params))
    return out


def check_train(ranks, ref, ctx):
    losses, params = ref
    for r, got in enumerate(ranks):
        assert len(got["losses"]) == len(losses)
        for a, b in zip(got["losses"], losses):
            assert abs(a - b) <= 1e-5 * abs(b), (ctx, r, a, b)
        assert got["params"].keys() == params.keys()
        for k in params:
            assert_params_close(got["params"][k], params[k], LR,
                                TRAIN["steps"], f"{ctx} rank {r} {k}")
    for got in ranks[1:]:            # the replicas stay equal
        for k in params:
            np.testing.assert_array_equal(got["params"][k],
                                          ranks[0]["params"][k])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_data_parallel_2x1_equals_the_reference(world2, train_refs,
                                                      arch):
    check_train([w["train"][arch] for w in world2], train_refs[arch],
                f"{arch} (2, 1)")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_data_parallel_2x2_equals_the_reference(world4, train_refs,
                                                      arch):
    """The MoE layers run expert-parallel over the model axis of 2, with
    the drops of the whole batch."""
    check_train([w["train"][arch] for w in world4], train_refs[arch],
                f"{arch} (2, 2)")


def test_train_restarts_the_world_from_rank_0s_checkpoint(worlds, inits,
                                                          tmp_path):
    """A step that fails on one rank of a mesh is re-raised, not restarted
    in place (its peer waits in the step's all-reduce), and the launcher
    ends the world; the checkpoint rank 0 wrote after step 1 is left, and
    a new world resumes from it on both ranks to the same losses and
    parameters as the port's one-process run that resumes alike."""
    got = worlds["restart"].result()
    assert got["error"] is not None, "the planted fault did not surface"
    assert re.search(r"rank 1 of 2 failed:[\s\S]*planted fault",
                     got["error"]), got["error"]
    assert got["fault_s"] < 60
    assert got["left"] == "step_00000001"
    cfg = t_configs.get(RESTART["arch"]).reduced()
    kw = dict(batch=RESTART["batch"], seq=RESTART["seq"], seed=0,
              device="cpu", init=inits[RESTART["arch"]], ckpt_every=1,
              ckpt_dir=str(tmp_path), print_fn=lambda *_: None)
    t_loop.train(cfg, steps=1, **kw)
    state, losses, rep = t_loop.train(cfg, steps=RESTART["steps"], **kw)
    assert rep.resumed_from == 1 and rep.steps_run == RESTART["steps"] - 1
    want = (losses, {n: leaf.numpy() for n, leaf in
                     t_flatten(state.params)})
    for r in got["ranks"]:
        assert r["report"]["resumed_from"] == 1
        assert r["report"]["steps_run"] == RESTART["steps"] - 1
        assert r["report"]["restarts"] == 0
    check_train(got["ranks"], want, "resumed (2, 1)")


# --------------------------------------------------------------- elastic

def test_restore_on_mesh_shards_equal_the_references(world4, ckpt_dir):
    """Every rank's shard of every leaf equals its block of the
    reference's ``restore_on_mesh`` on a 1 x 1 mesh, cut by the
    reference's own specs for (2, 2), bit for bit."""
    cfg = j_configs.get(ELASTIC_ARCH).reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    template = jax.eval_shape(j_build(cfg).init, jax.random.PRNGKey(0))
    step, full = j_elastic.restore_on_mesh(
        str(t_latest(ckpt_dir)), template, mesh)
    names = ref_paths(full)
    specs = dict(zip(names, jax.tree_util.tree_leaves(
        j_shd.param_specs(template, types.SimpleNamespace(
            shape={"data": 2, "model": 2})),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    sharded = 0
    for w in world4:
        got = w["elastic"]
        assert got["step"] == step == 7
        assert got["shards"].keys() == names.keys()
        for k, arr in names.items():
            want = arr
            for dim, entry in enumerate(specs[k]):
                if entry is None:
                    continue
                axes = (entry,) if isinstance(entry, str) else entry
                idx, cnt = 0, 1
                for a in axes:
                    idx, cnt = idx * 2 + got["coord"][a], cnt * 2
                n = arr.shape[dim] // cnt
                want = np.take(want, range(idx * n, (idx + 1) * n), dim)
                sharded += 1
            np.testing.assert_array_equal(got["shards"][k], want, err_msg=k)
    assert sharded > 0


# ------------------------------------------------------- world and meshes

def test_meshes_outside_a_world_raise():
    for make in (t_mesh.make_dev_mesh, t_mesh.make_fleet_mesh,
                 t_mesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="no process group"):
            make()


def test_production_mesh_needs_its_world_size(world4):
    for w in world4:
        assert "needs a world of 256 ranks, this one has 4" in w["production"]


def test_the_worlds_ranks_imported_no_jax(world4, world2):
    """Each body ends with ``no_jax()``; a rank that imported JAX would
    have failed its world."""
    assert [w["rank"] for w in world4] == [0, 1, 2, 3]
    assert len(world2) == 2


def test_spawn_reraises_a_failing_ranks_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:[\s\S]*"
                                           r"ValueError: rank 1 fails"):
        world.spawn(R.fail_on, 2, 1, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_spawn_times_out_a_hung_world():
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] gave no"):
        world.spawn(R.hang_on, 2, 1, device="cpu", timeout_s=3)
