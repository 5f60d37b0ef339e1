"""Mixture-of-Experts MLP, after ``repro.models.moe``: shared + routed
experts, top-k routing, capacity-based dropping.

The function is the reference's ``_moe_mlp_dense`` (``moe.py:77-115``):

  * an f32 softmax router, ``top_k`` with ties to the lower expert index
    (as ``lax.top_k``), the k weights renormalised;
  * each (token, slot) pair's place in its expert's queue, in token-major
    order; a pair whose place is at or past the capacity (``_capacity``)
    is dropped;
  * the kept pairs' expert SwiGLU/GeGLU outputs weighted and summed over
    the k slots, the shared experts added on top.

The reference scatters every pair into an (E, capacity, D) buffer and runs
each expert's matmuls over its whole buffer.  Dropless archs
(``capacity_factor`` 0, deepseek-v2-lite) have capacity = tokens, so that
buffer is (64, T, D) and its matmuls 64x the routed work.  The port
computes the same function on the kept pairs alone, by one of two paths
that the one-process layer chooses from its input (``grouped_path``):

  * a decode-sized call on a CUDA card without autograd (at most
    ``kernels.moe.MAX_TOKENS`` tokens, f32 or bf16) runs the routed
    experts as the grouped kernel pair ``kernels.moe.grouped_experts``:
    two launches that read the routing on the card, each expert hit
    streamed once, nothing read back;
  * every other call (prefill, training under autograd, where every
    expert needs a gradient, ``meta``, the CPU) takes the segment loop:
    the kept pairs are sorted by expert (stably, so each expert's rows
    stay in queue order) and each expert's matmuls run on its segment.
    The segments' lengths are read back to the host once a call; on
    ``meta`` (the op counter's shapes-only run) there is nothing to read,
    and each expert takes a balanced router's segment
    (``balanced_counts``).

Expert parallelism (the reference's ``_moe_mlp_shardmap``,
``moe.py:172-210``): when the ambient mesh (``distributed.context``) has
a ``model`` axis that divides ``num_experts``, each rank of a ``model``
group routes its tokens with the f32 router, runs only its ``e_local``
experts ``[e_lo, e_lo + e_local)`` (the reference's
``_dispatch_compute``, ``:118-170``, as the segment loop above), and one
all-reduce over ``model`` sums the partial outputs; the shared experts
are added after it.  The tokens are the rank's own: a rank's activations
are the rows of its ``(pod, data)`` shard already (``data.shard_batch``
gives them), where the reference's ``shard_map`` cuts them out of the
global array (``:180-189``).  So the capacity is taken over the rank's
tokens, as the reference's per-chip ``_capacity`` is (``:127``): with a
capacity factor, drops follow the data shard.  Data-parallel training
installs the mesh with ``global_batch`` (``distributed.context``): its
reference runs the layer over the whole batch (``_moe_mlp_dense``), so
each pair's queue place is shifted by its expert's pairs on the batch
blocks before the rank's (one all-gather of E counts over each batch
axis) and the capacity is that of the whole batch's tokens; the kept
pairs are then the reference's, on this path and on the one-process
path alike.  The expert weights may
be the full (E, ...) stacks, each rank slicing its own, or the rank's
(e_local, ...) shards alone (``sharding.local_shard`` under
``_MOE_RULES``).  Gradients: the input goes through ``copy_to_group``
(its gradient summed over ``model``) and the output through
``reduce_from_group`` (the replicated gradient passed through once), so
the layer's input gradient is whole on every rank; the router's and the
expert slices' parameter gradients are partial, each rank's part
(training on a ``model`` axis is tensor-parallel, below, where
``local_map`` places them so).  ``aux_load_balance_loss`` is the
reference's Switch-style loss.

Under tensor parallelism (DTensor parameters, ``distributed.
tensor_parallel``) the expert weights arrive as ``Shard(0)`` DTensors
over ``model`` and the shared experts' MLP column- then row-parallel
(``param_specs``); the layer runs per rank in ``local_map`` on the
weights' local shards (``to_local``: no second copy), the path above
with the shared experts' partial output added before the one
all-reduce over ``model``.  The tokens are the rank's rows of the batch
(its ``(pod, data)`` block), placed as the reference's whole batch
(``global_batch``).

With tracing on (``obs.enable()``) the one-process layer is a
``moe.dispatch`` span (tag ``tokens``) holding ``moe.route`` (the router
and the pairs' places), then on the segment loop ``moe.readback`` (the
segment lengths' read to the host, ``bytes``) and ``moe.experts`` (the
loop over the experts, tag ``segments``: the experts given at least one
kept pair), or on the grouped path ``moe.grouped`` (the kernel pair and
the combine, tags ``tokens`` and ``pairs``: T and T * k; the experts hit
are never read, so it claims no count of them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import obs
from ..configs.base import ArchConfig
from ..distributed import collectives as C
from ..distributed import context as dist_ctx
from ..distributed import sharding as shd
from ..distributed import tensor_parallel as tp
from ..distributed.tensor_parallel import Replicate, Shard
from ..kernels import moe as MK
from . import layers as L

Tensor = torch.Tensor


def init_moe(cfg: ArchConfig) -> dict:
    """The ``layers.Init`` tree of one MoE MLP: the f32 router (D, E), the
    stacked experts (E, D, F) / (E, F, D), and the shared experts as one
    dense MLP of width ``moe_d_ff * num_shared_experts``."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s_in, s_f = d ** -0.5, f ** -0.5
    p = {"router": L.Init((d, e), s_in, torch.float32),
         "w_gate": L.Init((e, d, f), s_in),
         "w_up": L.Init((e, d, f), s_in),
         "w_down": L.Init((e, f, d), s_f)}
    if cfg.num_shared_experts:
        p["shared"] = L.init_dense_mlp(d, cfg.moe_d_ff
                                       * cfg.num_shared_experts)
    return p


def balanced_counts(tokens: int, cfg: ArchConfig) -> list:
    """Kept (token, slot) pairs per expert, then the dropped ones, of a
    balanced router: the ``tokens * k`` pairs spread evenly over the E
    experts (the first ``tokens * k % E`` take one more), none above its
    ``_capacity``.  On ``meta`` the router's choice has no data, so the
    layer charges the op counter these segments: the one count of a step
    that differs from a real run's."""
    e, pairs = cfg.num_experts, tokens * cfg.top_k
    cap = _capacity(tokens, cfg)
    kept = [min(cap, pairs // e + (i < pairs % e)) for i in range(e)]
    return kept + [pairs - sum(kept)]


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    """Queue places an expert has: ``tokens`` when dropless
    (``capacity_factor <= 0``), else tokens * k / E * factor; padded to a
    multiple of 8, at least 8."""
    if cfg.capacity_factor <= 0:
        c = tokens
    else:
        c = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """Where each (token, slot) pair goes, flattened token-major (T * k)."""
    expert: Tensor     # int64 expert index
    weight: Tensor     # f32 renormalised gate weight
    pos: Tensor        # int64 place in the expert's queue
    keep: Tensor       # bool: pos < capacity
    gates: Tensor      # (T, E) f32 softmax of the router


def route(p, x2: Tensor, cfg: ArchConfig) -> Routing:
    """The reference's routing of ``x2`` (T, D)."""
    t, e, k = x2.shape[0], cfg.num_experts, cfg.top_k
    gates = torch.softmax(x2.float() @ p["router"], dim=-1)
    # a stable descending sort puts equal gates in index order: lax.top_k
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    counts = torch.zeros(e, dtype=torch.int64, device=x2.device
                         ).scatter_add_(0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(e_flat)
    pos[order] = (torch.arange(t * k, device=x2.device)
                  - starts[e_flat[order]])
    return Routing(e_flat, w.reshape(-1), pos, pos < _capacity(t, cfg),
                   gates)


def expert_counts(key: Tensor, cfg: ArchConfig) -> list:
    """The segment lengths of the expert keys ``key`` (T * k): kept pairs
    per expert, then the dropped ones, read back to the host; on ``meta``,
    which has no data, ``balanced_counts``."""
    if key.device.type == "meta":
        return balanced_counts(key.numel() // cfg.top_k, cfg)
    counts = torch.bincount(key, minlength=cfg.num_experts + 1)
    with obs.span("moe.readback",
                  bytes=counts.numel() * counts.element_size()):
        return counts.tolist()


def _batch_places(r: Routing, t: int, cfg: ArchConfig, mesh) -> Routing:
    """``r`` of this rank's ``t`` tokens, its ``(pod, data)`` block of a
    batch, with the places and drops of the whole batch: each pair's
    place shifted by the pairs of its expert on the blocks before this
    one (the flattened batch's order), the capacity that of all blocks'
    tokens.  Dropless archs keep every pair either way."""
    if cfg.capacity_factor <= 0 or shd.batch_axis_size(mesh) == 1:
        return r
    axes = shd.batch_axes(mesh)
    sizes, coord = shd.axis_sizes(mesh), shd.coordinate(mesh)
    counts = torch.bincount(r.expert, minlength=cfg.num_experts)[None]
    for ax in reversed(axes):      # the minor axis first: blocks in order
        if sizes[ax] > 1:
            counts = C.all_gather_rows(counts, mesh.get_group(ax))
    block = 0
    for ax in axes:
        block = block * sizes[ax] + coord[ax]
    pos = r.pos + counts[:block].sum(0)[r.expert]
    return r._replace(pos=pos,
                      keep=pos < _capacity(t * counts.shape[0], cfg))


def _route(p, x2: Tensor, cfg: ArchConfig, mesh) -> Routing:
    """``route``, over the whole batch under ``context.global_batch``."""
    with obs.span("moe.route"):
        r = route(p, x2, cfg)
        if (mesh is not None and dist_ctx.global_batch()
                and x2.device.type != "meta"):
            r = _batch_places(r, x2.shape[0], cfg, mesh)
        return r


def expert_parallel(cfg: ArchConfig, mesh) -> bool:
    """Whether an MoE layer of ``cfg`` runs expert-parallel on ``mesh``:
    a ``model`` axis that divides ``num_experts``."""
    if mesh is None:
        return False
    m = shd.axis_sizes(mesh).get("model")
    return m is not None and cfg.num_experts % m == 0


def grouped_path(device: torch.device, tokens: int, dtype: torch.dtype,
                 cfg: ArchConfig) -> bool:
    """Whether the one-process layer runs its routed experts as the
    grouped kernel pair (``kernels.moe.grouped_experts``) on a call of
    ``tokens`` tokens of ``dtype`` on ``device``: a CUDA device, autograd
    off (training needs every expert's gradient, which the loop gives),
    and a call the kernels take (at most ``MAX_TOKENS`` tokens, a decode
    step's, f32 or bf16, ``kernels.moe.fits``).  Every other call takes
    the segment loop (``_experts``)."""
    return (device.type == "cuda" and not torch.is_grad_enabled()
            and MK.fits(tokens, cfg.top_k, dtype, cfg.d_model, cfg.moe_d_ff))


def moe_mlp(p, x: Tensor, cfg: ArchConfig) -> Tensor:
    """x (..., D) -> (..., D) in x's dtype; expert-parallel under an
    ambient mesh with a ``model`` axis that divides ``num_experts``."""
    if tp.is_dtensor(x):
        return _moe_mlp_tp(p, x, cfg)
    mesh = dist_ctx.get_mesh()
    if expert_parallel(cfg, mesh):
        return _moe_mlp_expert_parallel(p, x, cfg, mesh)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    with obs.span("moe.dispatch", tokens=x2.shape[0]):
        r = _route(p, x2, cfg, mesh)
        if grouped_path(x2.device, x2.shape[0], x2.dtype, cfg):
            with obs.span("moe.grouped", tokens=x2.shape[0],
                          pairs=r.expert.numel()):
                # top-1's experts are a strided view of the router's sort
                y = MK.grouped_experts(
                    x2.contiguous(), r.expert.contiguous(), r.weight,
                    r.keep, p["w_gate"], p["w_up"], p["w_down"], cfg.act)
        else:
            # the kept pairs by expert in queue order, the dropped ones last
            key = torch.where(r.keep, r.expert, cfg.num_experts)
            y = _experts(p, x2, r, key, expert_counts(key, cfg), cfg)
        if "shared" in p:
            y = y + L.dense_mlp(p["shared"], x2, cfg.act)
        return y.reshape(shape)


def _experts(p, x2: Tensor, r: Routing, key: Tensor, counts: list,
             cfg: ArchConfig) -> Tensor:
    """Sum over the k slots of the weighted outputs of the pairs whose
    ``key`` names an expert of ``p`` (key i: ``p["w_*"][i]``; ``counts``
    the segment lengths, the last the pairs left out), (T, D)."""
    t, k = x2.shape[0], cfg.top_k
    with obs.span("moe.experts") as sp:
        rows = torch.sort(key, stable=True).indices
        y_tok = torch.zeros((t * k, x2.shape[-1]), dtype=x2.dtype,
                            device=x2.device)
        start = segments = 0
        # under autograd every expert's matmuls run, an empty segment's
        # too, so each expert weight gets a gradient (zero where no pair
        # went): the ranks of a mesh then agree on which gradients exist
        every = torch.is_grad_enabled()
        for ex, n in enumerate(counts[:-1]):
            if not n and not every:
                continue
            segments += n > 0
            seg = rows[start:start + n]
            start += n
            xe = x2[seg // k]
            a = xe @ p["w_gate"][ex]
            a = (F.silu(a) if cfg.act == "silu"
                 else F.gelu(a, approximate="tanh"))
            y_tok[seg] = (a * (xe @ p["w_up"][ex])) @ p["w_down"][ex]
        sp.set(segments=segments)
        y_tok = y_tok * (r.weight * r.keep).to(y_tok.dtype)[:, None]
        return y_tok.reshape(t, k, -1).sum(1)


def _local_experts(p, e_lo: int, e_local: int, cfg: ArchConfig) -> dict:
    """The rank's expert weights: sliced from full (E, ...) stacks, or the
    (e_local, ...) shards as given."""
    out = {}
    for name in ("w_gate", "w_up", "w_down"):
        w = p[name]
        if w.shape[0] == cfg.num_experts:
            w = w[e_lo:e_lo + e_local]
        elif w.shape[0] != e_local:
            raise ValueError(f"{name}: {w.shape[0]} experts, expected "
                             f"{cfg.num_experts} or this rank's {e_local}")
        out[name] = w
    return out


def _moe_mlp_expert_parallel(p, x: Tensor, cfg: ArchConfig, mesh,
                             shared_sharded: bool = False) -> Tensor:
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    e_local = cfg.num_experts // shd.axis_sizes(mesh)["model"]
    e_lo = shd.coordinate(mesh)["model"] * e_local
    group = mesh.get_group("model")
    xs = C.copy_to_group(x2, group)
    r = _route(p, xs, cfg, mesh)
    local = r.keep & (r.expert >= e_lo) & (r.expert < e_lo + e_local)
    key = torch.where(local, r.expert - e_lo, e_local)
    if key.device.type == "meta":       # a balanced router's segments
        kept = balanced_counts(x2.shape[0], cfg)[e_lo:e_lo + e_local]
        counts = kept + [key.numel() - sum(kept)]
    else:
        counts = torch.bincount(key, minlength=e_local + 1).tolist()
    y = _experts(_local_experts(p, e_lo, e_local, cfg), xs,
                 r._replace(keep=local), key, counts, cfg)
    if "shared" in p and shared_sharded:    # partial, summed with y
        y = y + L.dense_mlp(p["shared"], xs, cfg.act)
    y = C.reduce_from_group(y, group)
    if "shared" in p and not shared_sharded:
        y = y + L.dense_mlp(p["shared"], x2, cfg.act)
    return y.reshape(shape)


_NAMES = ("router", "w_gate", "w_up", "w_down")


def _moe_mlp_dense(p, x: Tensor, cfg: ArchConfig, mesh,
                   shared_sharded: bool = False) -> Tensor:
    """The one-process layer on experts replicated over ``model`` (the
    reference's ``_moe_mlp_dense``, where ``model`` does not divide the
    experts): every rank routes and runs all its tokens through every
    expert; a shared expert sharded over ``model`` adds its partial sums
    over the group."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    r = _route(p, x2, cfg, mesh)
    key = torch.where(r.keep, r.expert, cfg.num_experts)
    y = _experts(p, x2, r, key, expert_counts(key, cfg), cfg)
    if "shared" in p:
        if shared_sharded:
            group = mesh.get_group("model")
            y = y + C.reduce_from_group(L.dense_mlp(
                p["shared"], C.copy_to_group(x2, group), cfg.act), group)
        else:
            y = y + L.dense_mlp(p["shared"], x2, cfg.act)
    return y.reshape(shape)


def _moe_mlp_tp(p, x, cfg: ArchConfig):
    """``moe_mlp`` on DTensors: per rank on the local shards, the output
    replicated over ``model``; expert-parallel where ``model`` divides
    the experts, else the one-process layer on the replicated experts
    (``_moe_mlp_dense``)."""
    mesh = x.device_mesh
    ep = expert_parallel(cfg, mesh)
    names = [("", k) for k in _NAMES]
    if "shared" in p:
        names += [("shared", k) for k in ("w_gate", "w_up", "w_down")]
    ws = [p[k] if not d else p[d][k] for d, k in names]
    shared_sharded = "shared" in p and tp.on_model(p["shared"]["w_up"]) \
        == Shard(1)
    batch_sharded = any(isinstance(pl, Shard) for pl in x.placements)
    x_pl = tp.with_model(x, Replicate())
    grads = [x_pl] + [tp.grad_placements(w.placements, x,
                                         model_partial=ep and k == "router")
                      for (_, k), w in zip(names, ws)]
    body = _moe_mlp_expert_parallel if ep else _moe_mlp_dense

    def local(xl, *wl):
        pl = {k: w for (d, k), w in zip(names, wl) if not d}
        if "shared" in p:
            pl["shared"] = {k: w for (d, k), w in zip(names, wl) if d}
        with dist_ctx.use_mesh(mesh, global_batch=batch_sharded):
            return body(pl, xl, cfg, mesh, shared_sharded)

    return tp.run_local(local, (x, *ws),
                        (x_pl,) + tuple(w.placements for w in ws),
                        x_pl, mesh, grads)


def aux_load_balance_loss(p, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Switch-style auxiliary loss: E * dot(mean gate prob, token
    fraction), f32 0-d."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    gates = torch.softmax(x2 @ p["router"], dim=-1)
    idx = torch.sort(gates, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.top_k]
    frac = F.one_hot(idx, cfg.num_experts).float().mean((0, 1))
    return cfg.num_experts * torch.sum(frac * gates.mean(0))
