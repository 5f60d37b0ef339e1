"""Sharding rules, after ``repro.distributed.sharding``: parameter,
optimizer-state, activation and KV-cache specs for the meshes.

Conventions (the reference's):
  * ``pod``   — pure data parallelism across pods (gradient all-reduce)
  * ``data``  — data parallelism / context parallelism for long decode
  * ``model`` — tensor parallelism: heads, d_ff, experts, vocab, d_inner

A spec is the port's form of a ``PartitionSpec``: a tuple with one entry
a dimension, each None (replicated), an axis name, or a tuple of axis
names; ``()`` replicates a whole leaf, as ``P()`` does.  A mesh is a
``DeviceMesh`` (``launch.mesh``), or anything whose ``shape`` maps axis
names to sizes, which is all the rule functions read.

Parameters are matched by their leaf name (the last dict key on the
leaf's path) in the reference's tree, which ``models.weights.param_tree``
gives with the block leaves stacked (``pytree.Leaf``); any unmatched
leaf is replicated.  Divisibility is always checked: a dim that does not
tile over its axis falls back to replication.

``placements(spec, mesh)`` turns a spec into DTensor placements and
``local_shard(x, spec, mesh)`` cuts this rank's block out of a full
tensor or ``Leaf``.

The port's paths call the batch rules (``shard_batch``, the train
step, the MoE layer), ``param_specs`` through ``local_params``
(``restore_on_mesh``) and ``fleet_padding`` (the fleet); tensor
parallelism over DTensor (``distributed.tensor_parallel``) places the
parameters by ``param_spec``, AdamW's moments by ``opt_state_spec``, the
inputs by ``batch_spec`` and the decode caches by ``cache_shardings``
(``kv_cache_specs``), each through ``placements``.  ``fleet_spec``
names the fleet axis's prefix, which the fleet cuts by hand.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ArchConfig
from ..pytree import Leaf

Spec = Tuple[Any, ...]

# leaf-name -> (dim -> logical axis) ; dims not listed are replicated
_PARAM_RULES: Dict[str, Dict[int, str]] = {
    # embeddings
    "embed": {0: "model"},          # (V, D) vocab-sharded
    "unembed": {1: "model"},        # (D, V)
    # attention
    "wq": {1: "model"},
    "wk": {1: "model"},
    "wv": {1: "model"},
    "wo": {0: "model"},
    "w_ukv": {1: "model"},          # MLA up-projection (r, H*(nd+vd))
    "w_dkv": {},                    # small latent down-proj: replicated
    # dense mlp
    "w_gate": {1: "model"},         # (D, F) / moe (E, D, F) handled below
    "w_up": {1: "model"},
    "w_down": {0: "model"},
    # moe (3D weights: expert axis shards)
    "router": {},
    # mamba
    "w_z": {1: "model"},
    "w_x": {1: "model"},
    "w_B": {}, "w_C": {}, "w_dt": {},
    "conv_x": {1: "model"}, "conv_B": {}, "conv_C": {},
    "out_proj": {0: "model"},
}

_MOE_RULES = {"w_gate": {0: "model"}, "w_up": {0: "model"},
              "w_down": {0: "model"}}

# the rank of each matched leaf unstacked and outside an MoE
_BASE_NDIM = {"embed": 2, "unembed": 2, "wq": 2, "wk": 2, "wv": 2,
              "wo": 2, "w_ukv": 2, "w_dkv": 2, "w_gate": 2, "w_up": 2,
              "w_down": 2, "router": 2, "w_z": 2, "w_x": 2, "w_B": 2,
              "w_C": 2, "w_dt": 2, "conv_x": 2, "conv_B": 2, "conv_C": 2,
              "out_proj": 2}


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a mapping, or anything with
    a ``shape`` mapping (the reference's ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in batch_axes(mesh)]))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _map_named(fn, tree, *rest, name: Optional[str] = None):
    """``fn(name, leaf, *rest_leaves)`` over a tree of dicts, lists,
    tuples and NamedTuples, ``name`` the last dict key on the leaf's
    path (None above any dict), as the reference reads a ``DictKey``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_named(fn, tree[k], *(r[k] for r in rest), name=k)
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, getattr(tree, f),
                                       *(getattr(r, f) for r in rest),
                                       name=name) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, *(r[i] for r in rest),
                                     name=name)
                          for i, v in enumerate(tree))
    return fn(name, tree, *rest)


def _spec_for(name: Optional[str], leaf, mesh) -> Spec:
    shape = _shape(leaf)
    ndim = len(shape)
    base_ndim = _BASE_NDIM.get(name)
    if base_ndim is None:
        return ()  # norms, A_log, biases: replicated
    extra = ndim - base_ndim  # 0 (plain), 1 (stacked OR moe), 2 (stacked moe)
    if name in _MOE_RULES and extra >= 1:
        # (E, d, f) or (blocks, E, d, f): expert axis shards over model
        moe_dim = extra - 1
        spec = [None] * ndim
        if shape[moe_dim] % _axis_size(mesh, "model") == 0:
            spec[moe_dim] = "model"
            return tuple(spec)
        return ()
    spec = [None] * ndim
    for dim, ax in _PARAM_RULES[name].items():
        d = dim + extra
        if d < ndim and shape[d] % _axis_size(mesh, ax) == 0:
            spec[d] = ax
    return tuple(spec)


def param_specs(params_shape: Any, mesh) -> Any:
    """The spec tree of a params (shape) tree."""
    return _map_named(lambda n, x: _spec_for(n, x, mesh), params_shape)


def param_spec(name: Optional[str], leaf, mesh) -> Spec:
    """The spec of one leaf named ``name`` (its last dict key)."""
    return _spec_for(name, leaf, mesh)


def opt_state_spec(name: Optional[str], leaf, mesh, *,
                   zero1: bool = True) -> Spec:
    """The Adam moment spec of one leaf: its parameter's, and with
    ``zero1`` its largest replicated dim also sharded over ``data``
    (ZeRO-1 optimizer-state partitioning) when divisible."""
    spec = _spec_for(name, leaf, mesh)
    if not zero1:
        return spec
    dsize = _axis_size(mesh, "data")
    shape = _shape(leaf)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for d in np.argsort([-s for s in shape]):
        d = int(d)
        if parts[d] is None and shape[d] % dsize == 0 and \
                shape[d] >= 4 * dsize:
            parts[d] = "data"
            break
    return tuple(parts)


def opt_state_specs(params_shape: Any, mesh, *, zero1: bool = True) -> Any:
    """Adam moment specs (``opt_state_spec`` of each leaf)."""
    return _map_named(lambda n, x: opt_state_spec(n, x, mesh, zero1=zero1),
                      params_shape)


# ------------------------------------------------------------- activations

def batch_spec(mesh, global_batch: int, ndim: int = 2) -> Spec:
    """Shard dim0 (batch) over pod+data when divisible, else replicate."""
    axes = batch_axes(mesh)
    if axes and global_batch % batch_axis_size(mesh) == 0:
        return (axes,) + (None,) * (ndim - 1)
    return (None,) * ndim


def kv_cache_specs(cfg: ArchConfig, mesh, global_batch: int
                   ) -> Dict[str, Spec]:
    """Specs of the decode caches (by leaf name).

    Heads shard over ``model`` when divisible; otherwise the *sequence*
    dim shards over ``model`` (flash-decoding-style context parallelism),
    which also covers the batch=1 long-context case.  Batch shards over
    pod+data when divisible (else sequence takes ``data`` too)."""
    m = _axis_size(mesh, "model")
    baxes = batch_axes(mesh)
    batch_ok = global_batch % batch_axis_size(mesh) == 0 and len(baxes) > 0
    b_ax = baxes if batch_ok else None
    heads_ok = cfg.num_kv_heads % m == 0 and not cfg.mla
    if heads_ok:
        seq_ax = None if batch_ok else "data"
        head_ax = "model"
    else:
        seq_ax = ("model",) if batch_ok else ("data", "model")
        head_ax = None
    return {
        "k": (b_ax, seq_ax, head_ax, None),
        "v": (b_ax, seq_ax, head_ax, None),
        "pos": (None,),
        # MLA latent caches: no head dim; shard sequence
        "c_kv": (b_ax, seq_ax if seq_ax else ("model",), None),
        "k_rope": (b_ax, seq_ax if seq_ax else ("model",), None, None),
        # mamba caches
        "conv": (b_ax, None, "model"),
        "ssm": (b_ax, "model" if cfg.ssm_heads % max(m, 1) == 0 else None,
                None, None),
    }


def cache_shardings(cfg: ArchConfig, caches_shape: Any, mesh,
                    global_batch: int) -> Any:
    """The spec of every cache leaf (by leaf name; a leading dim past the
    table's, as a stacked cache has, is None; a dim that does not tile
    its axes falls back to None); ``enc_out`` (a ``models.Caches``
    attribute or a dict leaf) shards its batch dim."""
    table = kv_cache_specs(cfg, mesh, global_batch)

    def spec(name, leaf):
        shape = _shape(leaf)
        if name in table:
            parts = list(table[name])
            parts = [None] * (len(shape) - len(parts)) + parts
            for i, ax in enumerate(parts):
                if ax is None:
                    continue
                axes = (ax,) if isinstance(ax, str) else tuple(ax)
                size = int(np.prod([_axis_size(mesh, a) for a in axes]))
                if shape[i] % size != 0:
                    parts[i] = None
            return tuple(parts)
        if name == "enc_out":
            return batch_spec(mesh, global_batch, 3)
        return ()

    out = _map_named(spec, caches_shape)
    enc = getattr(caches_shape, "enc_out", None)
    if enc is not None:
        out = type(caches_shape)(out)
        out.enc_out = batch_spec(mesh, global_batch, 3)
    return out


# ------------------------------------------------------------ fleet axis
#
# The cache-sim fleet (runtime/fleet.py) stacks N replicas' EngineState
# rows along dim0 and advances them as one dispatch; over a mesh that
# dim shards over the ``fleet`` axis, each rank advancing its block of
# rows.  Every EngineState / PackedTraces leaf carries the replica-batch
# dim leading, so one spec prefix covers them all.

FLEET_AXIS = "fleet"


def fleet_spec() -> Spec:
    """Spec prefix of replica-stacked state: dim0 (the replica/tenant-row
    batch) shards over the fleet axis, every other dim stays local."""
    return (FLEET_AXIS,)


def fleet_padding(n_rows: int, mesh=None, *, bucket: bool = True) -> int:
    """Rows of padding so a replica batch (a) buckets to a power of two
    (few distinct shapes as governors diverge and replica groups churn)
    and (b) tiles the fleet mesh axis exactly (each rank takes an equal
    block).  Padding rows are fresh ``engine.init_state`` rows fed empty
    traces: provable no-ops, sliced off after the step."""
    assert n_rows > 0
    target = n_rows if not bucket else 1 << (n_rows - 1).bit_length()
    if mesh is not None and FLEET_AXIS in axis_sizes(mesh):
        ax = axis_sizes(mesh)[FLEET_AXIS]
        target = ((target + ax - 1) // ax) * ax
    return target - n_rows


# ------------------------------------------------------- specs to ranks

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that shards tensor dim d, ``Replicate()`` on the others."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def coordinate(mesh) -> Dict[str, int]:
    """{axis name: this rank's index} on ``mesh``; raises for a rank
    outside it."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def _block(n: int, entry, mesh, coord: Optional[Dict[str, int]] = None
          ) -> Tuple[int, int]:
    """(start, length) of this rank's block of a dim of ``n`` sharded over
    ``entry``'s axes (the first axis major, as a ``PartitionSpec`` tuple
    of axes)."""
    axes = _axes(entry)
    if not axes:
        return 0, n
    coord = coordinate(mesh) if coord is None else coord
    sizes = axis_sizes(mesh)
    idx, count = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        count *= sizes[a]
    if n % count:
        raise ValueError(f"a dim of {n} does not tile axes {axes} of "
                         f"{count}")
    k = n // count
    return idx * k, k


def local_shard(x, spec: Spec, mesh, coord: Optional[Dict[str, int]] = None):
    """This rank's block of ``x`` (a tensor or a ``Leaf``) under ``spec``:
    views of ``x``, no copy."""
    if isinstance(x, Leaf):
        ps = x.parts
        if x.stacked:
            start, k = _block(len(ps), spec[0] if spec else None, mesh, coord)
            ps, spec = ps[start:start + k], spec[1:]
        return Leaf([local_shard(p, spec, mesh, coord) for p in ps],
                    x.stacked)
    for d, entry in enumerate(spec):
        start, k = _block(x.shape[d], entry, mesh, coord)
        x = x.narrow(d, start, k)
    return x



def local_params(params: Any, mesh) -> Any:
    """This rank's shards of a params tree under ``param_specs`` (views)."""
    return _map_named(lambda n, x: local_shard(x, _spec_for(n, x, mesh),
                                               mesh), params)
