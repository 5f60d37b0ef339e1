"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``), in-process.

All ten configs at full width, shapes only: the reference's parameter
tree by ``jax.eval_shape`` of ``init``, the port's by ``LM(cfg,
device="meta")`` and ``param_tree``.  Meshes are duck-typed: the
reference's rule functions read only ``mesh.shape``, as the port's do.
Specs compare with a one-axis tuple and its name taken as equal (JAX
normalises ``P(("data",), ...)`` to ``P("data", ...)``).  Also the
port's own pieces: ``placements`` and ``local_shard`` on a
duck mesh with a given coordinate, and ``cache_shardings`` against
``kv_cache_specs``."""
import functools
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.checkpoint import checkpointer as j_ckpt  # noqa: E402
from repro.distributed import sharding as j_shd  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.pytree import Leaf, flatten  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = list(t_configs.ALL_ARCHS)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "4x1": {"data": 4, "model": 1},
          "fleet4": {"fleet": 4}}


def duck(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def norm(spec) -> tuple:
    """A spec as a tuple of (axes tuple or None), one entry a dim."""
    return tuple(None if e is None else
                 ((e,) if isinstance(e, str) else tuple(e)) for e in spec)


def spec_leaves(tree) -> list:
    """The port's spec tree's leaves in ``pytree.flatten``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return j_specs.abstract_params(j_build(j_configs.get(arch)))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return S.abstract_params(LM(t_configs.get(arch), device="meta"))


def ref_named(tree, arch) -> dict:
    names = j_ckpt._leaf_paths(ref_params(arch))[0]
    specs = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))
    assert len(names) == len(specs)
    return {n: norm(s) for n, s in zip(names, specs)}


def port_named(tree, arch) -> dict:
    names = [n for n, _ in flatten(port_params(arch))]
    specs = spec_leaves(tree)
    assert len(names) == len(specs)
    return {n: norm(s) for n, s in zip(names, specs)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(arch, mesh):
    want = ref_named(j_shd.param_specs(ref_params(arch), duck(mesh)), arch)
    got = port_named(shd.param_specs(port_params(arch), duck(mesh)), arch)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_are_the_references(arch, mesh):
    for zero1 in (True, False):
        want = ref_named(j_shd.opt_state_specs(ref_params(arch), duck(mesh),
                                               zero1=zero1), arch)
        got = port_named(shd.opt_state_specs(port_params(arch), duck(mesh),
                                             zero1=zero1), arch)
        assert got == want, zero1


def test_moe_experts_shard_over_model():
    """deepseek-moe-16b on (2, 2): each stacked expert leaf (blocks, E, d,
    f) shards its expert dim; the router does not (its dense prefix layer
    and the shared experts take the dense rules)."""
    got = port_named(shd.param_specs(port_params("deepseek-moe-16b"),
                                     duck("2x2")), "deepseek-moe-16b")
    experts = {n: s for n, s in got.items() if n.startswith("blocks/")
               and "/mlp/w_" in n}
    assert experts and all(s == (None, ("model",), None, None)
                           for s in experts.values())
    routers = [s for n, s in got.items() if n.endswith("/router")]
    assert routers and all(e is None for s in routers for e in s)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_is_the_references(mesh):
    for b in (1, 2, 3, 4, 8, 16, 32, 48, 256, 512):
        for ndim in (1, 2, 3):
            want = norm(j_shd.batch_spec(duck(mesh), b, ndim))
            assert norm(shd.batch_spec(duck(mesh), b, ndim)) == want, \
                (b, ndim)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_specs_are_the_references(arch, mesh):
    for b in (1, 2, 16, 32, 128):
        want = j_shd.kv_cache_specs(j_configs.get(arch), duck(mesh), b)
        got = shd.kv_cache_specs(t_configs.get(arch), duck(mesh), b)
        assert {k: norm(v) for k, v in got.items()} == \
            {k: norm(v) for k, v in want.items()}, b


@pytest.mark.parametrize("mesh", [None] + list(MESHES))
def test_fleet_padding_is_the_references(mesh):
    m = None if mesh is None else duck(mesh)
    for n in range(1, 70):
        for bucket in (True, False):
            assert shd.fleet_padding(n, m, bucket=bucket) == \
                j_shd.fleet_padding(n, m, bucket=bucket), (n, bucket)
    assert shd.fleet_spec() == tuple(j_shd.fleet_spec())
    assert shd.FLEET_AXIS == j_shd.FLEET_AXIS


def test_batch_axes_and_sizes_are_the_references():
    for mesh in MESHES:
        assert shd.batch_axes(duck(mesh)) == j_shd.batch_axes(duck(mesh))
        assert shd.batch_axis_size(duck(mesh)) == \
            j_shd.batch_axis_size(duck(mesh))


def mesh_at(shape: dict):
    """A duck ``DeviceMesh``: its axis names and sizes."""
    return types.SimpleNamespace(mesh_dim_names=tuple(shape),
                                 shape=tuple(shape.values()))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_at({"pod": 2, "data": 2, "model": 2})
    assert shd.placements((("pod", "data"), None), m) == \
        (Shard(0), Shard(0), Replicate())
    assert shd.placements((None, "model"), m) == \
        (Replicate(), Replicate(), Shard(1))
    assert shd.placements((), m) == (Replicate(),) * 3


def test_local_shard_cuts_each_ranks_block():
    """Every coordinate's blocks tile the tensor exactly once, the first
    axis of a dim's tuple major, as a ``PartitionSpec`` lays them out."""
    m = mesh_at({"pod": 2, "data": 2, "model": 2})
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = (("pod", "data"), "model", None)
    seen = torch.zeros_like(x)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                c = {"pod": pod, "data": data, "model": model}
                got = shd.local_shard(x, spec, m, c)
                r0, c0 = (pod * 2 + data) * 2, model * 3
                assert torch.equal(got, x[r0:r0 + 2, c0:c0 + 3])
                seen[r0:r0 + 2, c0:c0 + 3] += 1
    assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="does not tile"):
        shd.local_shard(torch.zeros(3, 2), ("data", None), m,
                        {"pod": 0, "data": 0, "model": 0})


def test_local_shard_of_a_stacked_leaf():
    m = mesh_at({"data": 2, "model": 2})
    parts = [torch.randn(4, 6) for _ in range(3)]
    leaf = Leaf(parts, stacked=True)
    got = shd.local_shard(leaf, (None, None, "model"), m,
                          {"data": 1, "model": 1})
    assert got.stacked and len(got.parts) == 3
    for g, p in zip(got.parts, parts):
        assert torch.equal(g, p[:, 3:])
    rows = shd.local_shard(Leaf([torch.randn(4, 2)] * 4, stacked=True),
                           ("data", None, None), m, {"data": 1, "model": 0})
    assert len(rows.parts) == 2


def test_cache_shardings_follow_kv_cache_specs():
    cfg = t_configs.get("qwen3-4b")
    mesh = duck("2x2")
    caches = LM(cfg, device="meta").init_caches(4, 64)
    specs = shd.cache_shardings(cfg, caches, mesh, 4)
    table = shd.kv_cache_specs(cfg, mesh, 4)
    assert len(specs) == len(caches)
    for layer in specs:
        assert layer == {"k": table["k"], "v": table["v"],
                         "pos": table["pos"]}
    odd = shd.cache_shardings(cfg, {"k": np.zeros((3, 64, 8, 128))}, mesh, 4)
    assert odd["k"] == (None, None, "model", None)   # 3 rows do not tile
