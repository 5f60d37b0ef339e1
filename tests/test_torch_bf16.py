"""The port's bfloat16 model path against the reference's, on all ten
architectures' ``reduced()`` configs with ``param_dtype="bfloat16"`` in
both packages (the reference's gemma3-27b and jamba-1.5-large publish
bf16 checkpoints and run in it; ``configs/base.py``'s note on dtype).

Weights: ``seeded_numpy_params`` loaded into the port's bf16 ``LM``,
which rounds each leaf to bf16 once (the MoE router, ``A_log`` and
``dt_bias`` stay float32 in both packages).  The reference runs on that
rounded tree in bf16 and in float32 (the config's f32 twin, every leaf
widened exactly): the oracle.  The port runs its plain versions
(``device="cpu"``).

The bound: for every compared quantity, the port's distance from the
oracle is at most ``RATIO`` (2) times the reference's bf16 distance from
it, plus a floor: ``1e-3 * max |oracle|`` for logits and caches, 1e-5
relative for the loss, 1e-3 relative Frobenius for a gradient leaf.  The
distance is the largest absolute difference (a gradient leaf's: the
Frobenius norm of the difference over the oracle's).  The reference's
distance is the larger of its two XLA lowerings' (``three_runs``), and
for the loss also its tokens' mean |cross-entropy error|.  A direct
port-against-reference bound would hold the two packages' bf16 roundings
to each other; the oracle measures each against the same exact answer.

Compared, each case over the ten families: ``forward``, ``prefill`` and 6
decode steps teacher-forced with the oracle's greedy tokens (so that one
near tie does not fork the sequences), every cache after each; the
port's greedy tokens equal the oracle's wherever the oracle's top-2
margin exceeds 4 times the largest bf16 error of the row (at least one
such row, or the check says nothing); ``LM.loss`` and every gradient
leaf (through the port's flash backward plain version).  Where a family
routes tokens to experts, the bf16 runs take the oracle's experts
(``Routing``: teacher-forced routing), and the port's own top-k equals
the oracle's on every token whose margin exceeds the bf16 gate error
(``check_routing``).  Seeds are the suite's: the tree 0, the batch 1.

Reduced jamba also runs at tree seeds 1-3 (``SWEEP_SEEDS``), and six of
its leaves are held by a rule over the seeds instead of the per-seed
bound (ROADMAP §C 12, not a port fault): layer 0's ``w_B``, ``w_C``,
``conv_B``, ``conv_C``, its ``ln1`` and the embedding (``JAMBA_SIX``).
Their bf16 gradients are ill-conditioned at this width: both packages
land 0.1-0.8 (relative Frobenius) from the oracle, and where the port
lands against the reference swings with the seed and the depth (0.54x-
6.6x at seeds 0-7, 0.09x-6.6x at depths 1-8 of seed 0), so one seed
says nothing of a fault.  The rule (``seed_rule``): for each of the six,
the median over the seeds of (the port's distance / the reference's) at
most RATIO.  A fault in their path moves them at every seed: a backward
fault that scales B's and C's gradients by 1.1 breaks it
(``test_bf16_jamba_seed_rule_catches_a_backward_fault``).  Every other
jamba leaf and the loss keep the per-seed bound at each seed."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels import attention as t_att  # noqa: E402
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402
from repro_torch.models.weights import param_tree  # noqa: E402
from repro_torch.pytree import flatten, from_parts, parts  # noqa: E402
from repro_torch.pytree import tree_map  # noqa: E402

from test_torch_models import extra_inputs, ref_layer_caches  # noqa: E402
from test_torch_train import batch_of, ref_paths, rel_fro  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

# The port's bf16 distance from the oracle over the reference's, measured
# on the CPU: at most 1.5 on logits and losses of these ten families (two
# seeds each); over gradient leaves 1.0-1.1 at the median and up to 1.7
# on gemma3's 16-element q_norm and k_norm leaves (tree seeds 0-3).  2
# leaves room for that spread without letting through a port that rounds
# twice as often.
RATIO = 2.0
LOGIT_FLOOR = 1e-3          # x max |oracle|: logits and caches
LOSS_FLOOR = 1e-5           # relative
GRAD_FLOOR = 1e-3           # relative Frobenius
GREEDY_MARGIN = 4.0         # x the larger bf16 error of a row
SEED, BATCH_SEED = 0, 1      # the suite's (tests/test_torch_train.py)
B, S, STEPS, MAX_LEN = 2, 12, 6, 24

# ROADMAP §C 12 (not a port fault): layer 0's B and C path of reduced
# jamba and, through it, its ln1 and the embedding.  Their bf16 gradients
# are ill-conditioned at this width: over tree seeds 0-7 the port sits
# 0.10-3.28 (relative Frobenius) from the oracle, the reference 0.12-0.83;
# the port's distance over the reference's is 4.0-6.6 at seed 0 and
# 0.54-1.36 at seeds 1-7, and seed 0 cut to 2 layers gives 0.09-0.14, to 3
# layers 3.3-3.8 (``python tests/test_torch_bf16.py seeds 8``, ``depths``).
# A fault would show at every seed, so the six are held by ``seed_rule``
# over SWEEP_SEEDS (medians 0.73-0.96), not by the per-seed bound.
JAMBA_SIX = ("blocks/l0/ln1", "blocks/l0/mixer/conv_B",
             "blocks/l0/mixer/conv_C", "blocks/l0/mixer/w_B",
             "blocks/l0/mixer/w_C", "embed")
SWEEP_SEEDS = (0, 1, 2, 3)  # tree seeds of the rule; the suite's first

ARCHS = sorted(t_configs.ALL_ARCHS)
JAMBA = "jamba-1.5-large-398b"


def cut(cfg, layers: int):
    """``cfg`` (no prefix layers) with its block pattern cut to its first
    ``layers`` layers, and no experts when none of them is an MoE
    layer (0: ``cfg`` itself)."""
    if not layers:
        return cfg
    pat = cfg.block_pattern[:layers]
    moe = any(s.mlp == "moe" for s in pat)
    return dataclasses.replace(
        cfg, num_layers=len(pat), block_pattern=pat,
        num_experts=cfg.num_experts if moe else 0)


def bf16_pair(arch: str, layers: int = 0):
    """(reference bf16, reference f32, port bf16) reduced configs, the
    block pattern cut to ``layers`` (``cut``)."""
    jc = cut(j_configs.get(arch).reduced(), layers)
    return (dataclasses.replace(jc, param_dtype="bfloat16"), jc,
            dataclasses.replace(cut(t_configs.get(arch).reduced(), layers),
                                param_dtype="bfloat16"))


def host(x) -> np.ndarray:
    """A host array of a reference leaf: bf16 as ml_dtypes.bfloat16 (the
    port hands bf16 out as its raw uint16 bits)."""
    a = np.asarray(x)
    return a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(host(x), np.float64)


def within(port, refs, oracle, floor: float, ctx: str) -> tuple:
    """The bound on the largest absolute difference: the port's from the
    oracle at most RATIO x the reference's (the larger of its lowerings'
    ``refs``) plus ``floor`` x max |oracle|.  Returns (port's,
    reference's) distances."""
    o = f64(oracle)
    p_err = float(np.abs(f64(port) - o).max(initial=0.0))
    r_err = max(float(np.abs(f64(r) - o).max(initial=0.0)) for r in refs)
    lim = RATIO * r_err + floor * float(np.abs(o).max(initial=0.0))
    assert p_err <= lim, (f"{ctx}: the port's bf16 is {p_err:.4g} from the "
                          f"oracle, the reference's {r_err:.4g} (limit "
                          f"{lim:.4g})")
    return p_err, r_err


def greedy_rows(port, refs, oracle) -> int:
    """The port's greedy tokens equal the oracle's on every row whose
    oracle top-2 margin exceeds GREEDY_MARGIN x the largest bf16 error
    on that row (the port's or a reference lowering's); returns how many
    rows that was."""
    p, o = f64(port), f64(oracle)
    top2 = -np.sort(-o, axis=-1)[:, :2]
    err = np.abs(p - o).max(-1)
    for r in refs:
        err = np.maximum(err, np.abs(f64(r) - o).max(-1))
    sure = top2[:, 0] - top2[:, 1] > GREEDY_MARGIN * err
    bad = sure & (p.argmax(-1) != o.argmax(-1))
    assert not bad.any(), f"greedy token differs on rows {np.nonzero(bad)}"
    return int(sure.sum())


class Family:
    """One architecture's three models on one weight tree: the port in
    bf16, the reference in bf16 and the oracle (the reference in f32 on
    the rounded weights)."""

    def __init__(self, arch: str, seed: int = SEED, layers: int = 0):
        jc16, jc32, tc = bf16_pair(arch, layers)
        self.cfg = tc
        self.routing = Routing()
        self.port = LM(tc, device="cpu")
        params_from_numpy(self.port, seeded_numpy_params(tc, seed))
        tree = tree_map(lambda leaf: host(leaf.numpy()),
                        param_tree(self.port))
        self.ref = j_tf.LM(jc16), jax.tree_util.tree_map(jnp.asarray, tree)
        self.oracle = j_tf.LM(jc32), jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)


_FAMILIES = {}


def family(arch: str, seed: int = SEED, layers: int = 0) -> Family:
    key = (arch, seed, layers)
    if key not in _FAMILIES:
        _FAMILIES.clear()               # one family's trees at a time
        _FAMILIES[key] = Family(arch, seed, layers)
    return _FAMILIES[key]


def test_rounded_weights_are_bf16_but_the_kept_leaves():
    """The port's bf16 LM holds every leaf in bf16 but the router,
    ``A_log`` and ``dt_bias``, as the reference's ``init`` does, and the
    trees handed to the reference carry the same dtypes."""
    for arch in ("jamba-1.5-large-398b", "deepseek-moe-16b", "gemma3-27b"):
        jc16, _, tc = bf16_pair(arch)
        init = jax.eval_shape(j_tf.LM(jc16).init, jax.random.PRNGKey(0))
        want = {jax.tree_util.keystr(k): np.dtype(v.dtype) for k, v in
                jax.tree_util.tree_leaves_with_path(init)}
        fam = family(arch)
        got = {jax.tree_util.keystr(k): np.dtype(v.dtype) for k, v in
               jax.tree_util.tree_leaves_with_path(fam.ref[1])}
        assert got == want, arch
        assert all(v.dtype == jnp.float32 for v in
                   jax.tree_util.tree_leaves(fam.oracle[1])), arch


def moe_gates(model, params, batch) -> list:
    """The reference's router gates (tokens, E) of every MoE call of a
    forward, in call order."""
    gates = []
    real = j_moe._moe_mlp_dense

    def tap(p, x, cfg):
        x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        jax.debug.callback(lambda g: gates.append(np.asarray(g, np.float64)),
                           jax.nn.softmax(x2 @ p["router"], -1))
        return real(p, x, cfg)
    j_moe._moe_mlp_dense = tap
    try:
        jax.block_until_ready(jit16(model.forward, {})(params, batch))
        jax.effects_barrier()
    finally:
        j_moe._moe_mlp_dense = real
    return gates


def port_gates(model, batch) -> list:
    """The port's router gates of every MoE call of a forward."""
    gates = []
    real = t_moe.route

    def tap(p, x2, cfg):
        r = real(p, x2, cfg)
        gates.append(r.gates.double().numpy())
        return r
    t_moe.route = tap
    try:
        model(batch)
    finally:
        t_moe.route = real
    return gates


def top_k_sets(g: np.ndarray, k: int) -> np.ndarray:
    return np.sort(np.argsort(-g, axis=-1, kind="stable")[:, :k], axis=-1)


def check_routing(fam: Family, nb: dict, ctx: str) -> dict:
    """Every MoE call of a forward: the port's top-k expert set of a token
    equal to the oracle's wherever the oracle's top-k margin (k-th gate
    less the (k+1)-th) exceeds the call's bf16 gate error (the larger of
    the two packages' largest |gate - oracle's|), and at least one such
    token.  A batch of 24-32 tokens always holds near ties at bf16 (over
    60 batches no jamba batch and few deepseek ones had none), so near
    ties are counted here, and the bounds run with the routing pinned
    (``Routing``)."""
    k = fam.cfg.top_k
    jb = {key: jnp.asarray(v) for key, v in nb.items()}
    want = moe_gates(*fam.oracle, jb)
    ref = moe_gates(*fam.ref, jb)
    got = port_gates(fam.port, {key: torch.from_numpy(v)
                                for key, v in nb.items()})
    assert want and len(got) == len(ref) == len(want), ctx
    out = {"calls": len(want), "tokens": 0, "near_ties": 0}
    for c, (gp, gr, go) in enumerate(zip(got, ref, want)):
        err = max(np.abs(gp - go).max(), np.abs(gr - go).max())
        g = -np.sort(-go, axis=-1)
        sure = g[:, k - 1] - g[:, k] > err
        bad = np.nonzero(sure & (top_k_sets(gp, k) != top_k_sets(go, k))
                         .any(-1))[0]
        assert not len(bad), (f"{ctx} MoE call {c}: token {bad[0]} routed "
                              f"away from the oracle's experts")
        out["tokens"] += int(sure.sum())
        out["near_ties"] += int((~sure).sum())
    assert out["tokens"] >= 1, f"{ctx}: every token on a routing tie"
    return out


class _PinnedLax:
    """``jax.lax`` with ``top_k`` pinned (see ``Routing``)."""

    def __init__(self, routing):
        self.routing = routing

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def top_k(self, gates, k):
        return self.routing.top_k(gates, k)


class _PinnedJax:
    def __init__(self, routing):
        self.lax = _PinnedLax(routing)

    def __getattr__(self, name):
        return getattr(jax, name)


class Routing:
    """Teacher-forced routing, as the decode is teacher-forced: every
    token of a bf16 run goes to the experts the oracle chose for it, with
    its own gates.  A batch of 24-32 tokens always holds top-k near ties
    at bf16 (``check_routing``), and a tie that one package breaks the
    other way moves that token's output by a whole expert's, which says
    nothing of either package's rounding (jamba: gradient leaves 1.2 and
    2.6 in relative Frobenius distance from the oracle unpinned).

    ``record()`` keeps each MoE call's top-k indices of the oracle's run
    (reference, at run time, in call order); ``replay(pkg)`` feeds them,
    in the same order, to the reference's ``lax.top_k`` (as constants, at
    trace time: the reference's replayed calls are traced anew, eagerly
    or by one ``jit`` a call) or to the port's ``models.moe.route``."""

    def __init__(self):
        self.calls, self.next, self.mode = [], 0, None

    def record(self):
        self.calls, self.mode = [], "record"
        return self._patch(j_moe, "jax", _PinnedJax(self))

    def replay(self, pkg: str):
        self.next, self.mode = 0, "replay"
        if pkg == "ref":
            return self._patch(j_moe, "jax", _PinnedJax(self))
        return self._patch(t_moe, "route", self._route)

    class _patch:
        def __init__(self, mod, name, value):
            self.mod, self.name, self.value = mod, name, value

        def __enter__(self):
            self.real = getattr(self.mod, self.name)
            setattr(self.mod, self.name, self.value)

        def __exit__(self, *exc):
            setattr(self.mod, self.name, self.real)

    def _pop(self) -> np.ndarray:
        # the reference may trace a scanned block twice (its carry's
        # types): each trace takes the calls in order
        idx = self.calls[self.next % len(self.calls)]
        self.next += 1
        return idx

    def top_k(self, gates, k):
        if self.mode == "replay":
            idx = jnp.asarray(self._pop())
            return jnp.take_along_axis(gates, idx, -1), idx
        w, idx = jax.lax.top_k(gates, k)
        jax.debug.callback(lambda i: self.calls.append(np.asarray(i)), idx,
                           ordered=True)
        return w, idx

    def _route(self, p, x2, cfg):
        """``models.moe.route`` with the recorded experts."""
        t, e, k = x2.shape[0], cfg.num_experts, cfg.top_k
        gates = torch.softmax(x2.float() @ p["router"], dim=-1)
        idx = torch.from_numpy(self._pop()).long()
        w = torch.gather(gates, 1, idx)
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
        e_flat = idx.reshape(-1)
        order = torch.sort(e_flat, stable=True).indices
        counts = torch.zeros(e, dtype=torch.int64).scatter_add_(
            0, e_flat, torch.ones_like(e_flat))
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.empty_like(e_flat)
        pos[order] = torch.arange(t * k) - starts[e_flat[order]]
        return t_moe.Routing(e_flat, w.reshape(-1), pos,
                             pos < t_moe._capacity(t, cfg), gates)


def serving_batch(cfg):
    r = np.random.default_rng(BATCH_SEED)
    tokens = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tokens, **extra_inputs(cfg, B, S, r)}


def check_caches(port, refs, oracle, cfg, ctx: str) -> None:
    """Every layer's cache (the reference's per layer): positions equal,
    every other field under the bound."""
    oracle = ref_layer_caches(oracle, cfg)
    refs = [ref_layer_caches(r, cfg) for r in refs]
    assert len(port) == len(oracle) and all(len(r) == len(oracle)
                                            for r in refs)
    for li, (p, o) in enumerate(zip(port, oracle)):
        assert sorted(p) == sorted(o), f"{ctx} layer {li}"
        for f in p:
            if f == "pos":
                for x in [p[f].numpy()] + [r[li][f] for r in refs]:
                    np.testing.assert_array_equal(np.asarray(x),
                                                  np.asarray(o[f]))
            else:
                within(p[f], [r[li][f] for r in refs], o[f], LOGIT_FLOOR,
                       f"{ctx} layer {li} {f}")


LOWERINGS = ({}, {"xla_allow_excess_precision": False})


def three_runs(fam: Family, oracle, ref, port) -> tuple:
    """(oracle(), [ref(options) for each of the reference's two XLA
    lowerings], port()).  The default lowering keeps excess precision
    (it skips bf16 roundings of some intermediates, which the port makes
    as written); without it the reference rounds as written.  Its bf16
    program admits both, so its bf16 distance is the larger.  For an MoE
    family the bf16 runs take the oracle's experts (``Routing``), which
    ``ref`` must trace anew (a fresh ``jit``)."""
    if not fam.cfg.num_experts:
        return (oracle(), [ref(opt) for opt in LOWERINGS],
                port() if port else None)
    with fam.routing.record():
        o = oracle()
        jax.effects_barrier()
    refs = []
    for opt in LOWERINGS:
        with fam.routing.replay("ref"):
            refs.append(ref(opt))
        assert fam.routing.next % len(fam.routing.calls) == 0
    if port is None:
        return o, refs, None
    with fam.routing.replay("port"):
        p = port()
    assert fam.routing.next % len(fam.routing.calls) == 0
    return o, refs, p


def jit16(fn, opt):
    """A fresh ``jit`` of ``fn`` with compiler options ``opt``."""
    return jax.jit(lambda *a: fn(*a), compiler_options=opt)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_prefill_and_decode_hold_the_oracle(arch):
    fam = family(arch)
    cfg, tm = fam.cfg, fam.port
    (jm16, jp16), (jm32, jp32) = fam.ref, fam.oracle
    nb = serving_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    if cfg.num_experts:
        check_routing(fam, nb, arch)

    o, r, p = three_runs(fam, lambda: jit16(jm32.forward, {})(jp32, jb),
                         lambda opt: jit16(jm16.forward, opt)(jp16, jb),
                         lambda: tm(tb))
    within(p, r, o, LOGIT_FLOOR, f"{arch} forward")

    jb.pop("positions", None)       # prefill reads none (as the
    tb.pop("positions", None)       # reference's prefill does not)
    (ol, oc), rs, (pl, pc) = three_runs(
        fam, lambda: jax.jit(jm32.prefill)(jp32, jb,
                                           jm32.init_caches(B, MAX_LEN)),
        lambda opt: jit16(jm16.prefill, opt)(jp16, jb,
                                             jm16.init_caches(B, MAX_LEN)),
        lambda: tm.prefill(tb, tm.init_caches(B, MAX_LEN)))
    rls, rcs = [x[0] for x in rs], [x[1] for x in rs]
    within(pl, rls, ol, LOGIT_FLOOR, f"{arch} prefill")
    check_caches(pc, rcs, oc, cfg, f"{arch} prefill")
    sure = greedy_rows(pl, rls, ol)
    odec = jax.jit(jm32.decode_step)
    rdec = [jit16(jm16.decode_step, opt) for opt in LOWERINGS]
    for t in range(STEPS):
        tok = np.asarray(jnp.argmax(ol, -1)).astype(np.int32)
        jt, pos = jnp.asarray(tok), jnp.int32(S + t)
        (ol, oc), rs, (pl, pc) = three_runs(
            fam, lambda: odec(jp32, jt, oc, pos),
            lambda opt: (jit16(jm16.decode_step, opt) if cfg.num_experts
                         else rdec[LOWERINGS.index(opt)])(
                jp16, jt, rcs[LOWERINGS.index(opt)], pos),
            lambda: tm.decode_step(torch.from_numpy(tok), pc, S + t))
        rls, rcs = [x[0] for x in rs], [x[1] for x in rs]
        within(pl, rls, ol, LOGIT_FLOOR, f"{arch} step {t}")
        check_caches(pc, rcs, oc, cfg, f"{arch} step {t}")
        sure += greedy_rows(pl, rls, ol)
    assert sure >= 1, f"{arch}: no greedy token compared"


def port_grads(tm, nb) -> tuple:
    """(loss, {leaf path: gradient as float64}) of the port's bf16 LM
    (without remat, which gives the same numbers and routes each MoE call
    once)."""
    tm.requires_grad_(True)
    try:
        pt = param_tree(tm)
        loss = tm.loss({k: torch.from_numpy(v) for k, v in nb.items()},
                       remat=False)
        flat = parts(pt)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        tm.requires_grad_(False)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, flat)]
    return loss, {n: f64(host(x.numpy())) for n, x in
                  flatten(from_parts(pt, gs))}


def token_ce(logits, targets) -> np.ndarray:
    """Each token's cross-entropy (logsumexp - gold) in float64."""
    x = f64(logits)
    m = x.max(-1, keepdims=True)
    logz = np.log(np.exp(x - m).sum(-1)) + m[..., 0]
    return logz - np.take_along_axis(x, targets[..., None], -1)[..., 0]


_GRADS = {}


def loss_with_logits(model, remat: bool):
    """``model.loss`` (the reference's: the cross-entropy of ``forward``'s
    logits) returning its logits as well, for ``value_and_grad``'s
    ``has_aux``: one program gives the loss, its gradients and each
    token's cross-entropy."""
    def fn(params, batch):
        logits = model.forward(params, batch, remat=remat)
        return j_layers.cross_entropy(logits, batch["targets"],
                                      model.cfg.vocab_size), logits
    return jax.value_and_grad(fn, has_aux=True)


def loss_and_grads(arch: str, seed: int = SEED, layers: int = 0) -> dict:
    """The loss and every gradient leaf of the oracle, of the reference's
    two bf16 lowerings and of the port (routing pinned for an MoE
    family), with the reference's per-token cross-entropy distance, on
    the tree of ``seed`` (the block pattern cut to ``layers``: ``cut``);
    kept for later tests, with the oracle's experts of each MoE call.
    Routing is checked (``check_routing``) at the suite's seed and depth
    only.  The oracle runs without remat (the same numbers), so that each
    MoE call is recorded once."""
    key = (arch, seed, layers)
    if key in _GRADS:
        return _GRADS[key]
    fam = family(arch, seed, layers)
    cfg = fam.cfg
    nb = batch_of(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    (jm16, jp16), (jm32, jp32) = fam.ref, fam.oracle
    routing = (check_routing(fam, nb, arch)
               if cfg.num_experts and key == (arch, SEED, 0) else None)
    t_att.reset_launches()
    ((ol, o32), og), refs, (pl, pg) = three_runs(
        fam, lambda: jit16(loss_with_logits(jm32, False), {})(jp32, jb),
        lambda opt: jit16(loss_with_logits(jm16, True), opt)(jp16, jb),
        lambda: port_grads(fam.port, nb))
    backward_runs = t_att.plain_runs["flash_attention_backward"]
    ce_o = token_ce(o32, nb["targets"])
    _GRADS[key] = dict(
        oracle=(float(ol), ref_paths(og)),
        refs=[(float(rl), ref_paths(g)) for (rl, _), g in refs],
        port=(pl, pg), backward_runs=backward_runs, routing=routing,
        experts=list(fam.routing.calls),
        token_ce=[float(np.abs(token_ce(r, nb["targets"]) - ce_o).mean())
                  for (_, r), _ in refs])
    return _GRADS[key]


def leaf_distances(res: dict, port=None) -> dict:
    """{leaf: (the port's, the reference's) relative Frobenius distance of
    its gradient from the oracle's}, the reference's the larger of its
    two lowerings'; ``port`` replaces the port's gradients."""
    want = res["oracle"][1]
    pg = res["port"][1] if port is None else port
    return {k: (rel_fro(pg[k], want[k]),
                max(rel_fro(f64(g[k]), want[k]) for _, g in res["refs"]))
            for k in want}


def loss_distances(res: dict) -> tuple:
    """(the port's |loss - oracle's|, the reference's: the larger of its
    lowerings' and its tokens' mean |cross-entropy error|, the oracle's
    loss)."""
    ol = res["oracle"][0]
    pl = float(res["port"][0].detach())
    return (abs(pl - ol), max([abs(rl - ol) for rl, _ in res["refs"]]
                               + res["token_ce"]), ol)


def hold_loss_and_leaves(res: dict, ctx: str, skip=()) -> None:
    """The per-seed bound on the loss (``loss_distances``) and on every
    gradient leaf but ``skip``."""
    p, r, ol = loss_distances(res)
    assert p <= RATIO * r + LOSS_FLOOR * abs(ol), (
        f"{ctx}: loss {p:.3g} from the oracle's {ol}, the reference's "
        f"{r:.3g}")
    want, pg = res["oracle"][1], res["port"][1]
    assert sorted(pg) == sorted(want) == sorted(res["refs"][0][1])
    for k, (p_err, r_err) in leaf_distances(res).items():
        assert pg[k].shape == want[k].shape, k
        assert k in skip or p_err <= RATIO * r_err + GRAD_FLOOR, (
            f"{ctx} {k}: gradient {p_err:.4g} from the oracle, the "
            f"reference's {r_err:.4g}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_hold_the_oracle(arch):
    """The loss: the reference's bf16 distance is the larger of its loss's
    and its tokens' mean |cross-entropy - oracle's| (a mean of signed
    per-token errors cancels by chance: seamless's reference loss came
    3.0e-5 from the oracle with per-token errors of std 1.2e-3).  Every
    gradient leaf under the bound, but jamba's six of ROADMAP §C 12,
    which ``seed_rule`` holds."""
    res = loss_and_grads(arch)
    pl = res["port"][0]
    assert pl.dtype == torch.float32 and pl.dim() == 0
    hold_loss_and_leaves(res, arch, JAMBA_SIX if arch == JAMBA else ())
    has_attn = any(s.mixer == "attn" for s in family(arch).port.specs)
    assert (res["backward_runs"] > 0) == has_attn


@pytest.mark.parametrize("seed", SWEEP_SEEDS)
def test_bf16_jamba_gradients_over_tree_seeds(seed):
    """Reduced jamba at each tree seed of the rule (the batch the
    suite's): the loss and every gradient leaf but the six of JAMBA_SIX
    under the per-seed bound; the six's distances are kept for
    ``seed_rule``."""
    hold_loss_and_leaves(loss_and_grads(JAMBA, seed),
                         f"{JAMBA} tree seed {seed}", JAMBA_SIX)


def seed_rule(dists: list) -> None:
    """ROADMAP §C 12's rule over the tree seeds: for each leaf of
    JAMBA_SIX, the median over the seeds of (the port's distance / the
    reference's) at most RATIO.  ``dists`` holds ``leaf_distances`` a
    seed.  A leaf whose bf16 gradient is ill-conditioned lands anywhere
    within a few times the reference's noise at one seed (0.54x-6.6x over
    tree seeds 0-7); a fault in its path moves it at every seed, and so
    moves the median."""
    med = {k: float(np.median([d[k][0] / d[k][1] for d in dists]))
           for k in JAMBA_SIX}
    bad = {k: m for k, m in med.items() if m > RATIO}
    assert not bad, (f"median over tree seeds of the port's / the "
                     f"reference's distance above {RATIO}: {bad}")


def test_bf16_jamba_six_leaves_hold_the_seed_rule():
    """The six leaves of ROADMAP §C 12 by ``seed_rule`` over SWEEP_SEEDS
    (seed 0, the suite's, among them)."""
    seed_rule([leaf_distances(loss_and_grads(JAMBA, s))
               for s in SWEEP_SEEDS])


class GradScale(torch.autograd.Function):
    """The identity forward; the backward scales the gradient by
    ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def port_rerun(seed: int) -> tuple:
    """(loss, gradients) of the port's bf16 reduced jamba at tree seed
    ``seed`` again, with the oracle's experts of ``loss_and_grads``'s run
    replayed; no reference run."""
    res = loss_and_grads(JAMBA, seed)
    tc = bf16_pair(JAMBA)[2]
    tm = LM(tc, device="cpu")
    params_from_numpy(tm, seeded_numpy_params(tc, seed))
    routing = Routing()
    routing.calls = res["experts"]
    with routing.replay("port"):
        loss, pg = port_grads(tm, batch_of(tc))
    assert routing.next == len(routing.calls)
    return float(loss.detach()), pg


MUTANT_FACTOR = 1.25    # the fault the rule must catch (see below)


def test_bf16_jamba_seed_rule_catches_a_backward_fault(monkeypatch):
    """Teeth for ``seed_rule``: a fault of the kind §C 12 was taken to
    be, backward only, so the forward (and every logit and loss check)
    stays exact.  Every Mamba2 layer's B and C pass through their
    forward unchanged and their gradients are scaled by MUTANT_FACTOR
    (``GradScale`` around ``_project``'s outputs); the port runs again at
    each tree seed, against the cached oracle's and reference's
    gradients; the rule now fails.  Without the fault the rerun gives the
    cached gradients bit for bit.  Of the factors 1.05, 1.1, 1.15, 1.25,
    1.5 and 2 the rule caught 1.1 and above (the six's medians 2.05-2.37
    at 1.1, 3.87-5.60 at 1.25) and missed 1.05 (1.29-1.55):
    ``python tests/test_torch_bf16.py mutants``.

    A limit of the rule: a fault of bf16 size is below it.  One extra
    bf16 rounding of the SSD's intra-chunk ``scores`` (``ssd_chunked``,
    ``_RoundScores``) left the six at tree seeds 1 and 2 at 0.16-0.20
    and 0.10-0.13, no worse than the unmutated port (medians 0.60-0.80)."""
    from repro_torch.models import mamba2 as t_mamba2
    loss, base = port_rerun(0)
    want = loss_and_grads(JAMBA, 0)["port"]
    assert loss == float(want[0].detach())
    assert all(np.array_equal(base[k], want[1][k]) for k in want[1])
    real = t_mamba2._project

    def faulty(p, x, cfg):
        z, xs, Bm, Cm, dt = real(p, x, cfg)
        return (z, xs, GradScale.apply(Bm, MUTANT_FACTOR),
                GradScale.apply(Cm, MUTANT_FACTOR), dt)
    monkeypatch.setattr(t_mamba2, "_project", faulty)
    dists = []
    for s in SWEEP_SEEDS:
        res = loss_and_grads(JAMBA, s)
        loss, pg = port_rerun(s)
        assert loss == float(res["port"][0].detach())    # forward exact
        dists.append(leaf_distances(res, pg))
    with pytest.raises(AssertionError, match="median over tree seeds"):
        seed_rule(dists)


def test_training_a_depth_with_no_block_repeat():
    """ROADMAP §C 13 (fixed): gemma3 cut to its two prefix layers has no
    repeat of its block pattern, so each block leaf is empty (the
    reference's stacks of length 0); the port's AdamW read such a leaf's
    rank and failed.  Two AdamW steps of that depth now match the
    reference's: losses within 1e-5 relative, each parameter leaf within
    1e-3 in relative Frobenius norm."""
    from repro.optim import AdamW as JAdamW
    from repro.optim import cosine_with_warmup as j_cosine
    from repro.train import train_step as j_ts
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.train import train_step as t_ts
    jc, tc = (dataclasses.replace(m.get("gemma3-27b").reduced(), num_layers=2)
              for m in (j_configs, t_configs))
    assert tc.num_blocks == 0
    tree = seeded_numpy_params(tc, 0)
    batches = [batch_of(tc, b=2, s=16, seed=10 + i) for i in range(2)]
    lr = 1e-2
    jopt = JAdamW(learning_rate=lr, schedule=j_cosine(1, 2))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = j_ts.TrainState(jp, jopt.init(jp), None)
    jstep = jax.jit(j_ts.make_train_step(j_tf.LM(jc), jopt))
    topt = AdamW(learning_rate=lr, schedule=cosine_with_warmup(1, 2))
    tm = LM(tc, device="cpu")
    tstate = t_ts.init_state(tm, topt, tree)
    tstep = t_ts.make_train_step(tm, topt)
    for nb in batches:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in nb.items()})
        jl, tl = float(jmet["loss"]), float(tmet["loss"])
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    want, got = ref_paths(jstate.params), dict(flatten(tstate.params))
    assert sorted(want) == sorted(got)
    for k in want:
        if want[k].size == 0:         # a block leaf: no layer holds it
            assert not got[k].parts, k
        else:       # a few elements whose gradient cancels to roundoff
            # take Adam's first step (+-lr) the other way: 8 of the 32 768
            # of the embedding here (tests/test_torch_train.py's
            # assert_params_close)
            assert rel_fro(got[k].numpy(), want[k]) <= 1e-3, k



GOLDEN_JAMBA = (Path(__file__).resolve().parent / "data"
                / "torch_golden_bf16_jamba.json")


def jamba_golden() -> dict:
    """``GOLDEN_JAMBA``'s content: for each of SWEEP_SEEDS, the crc32 of
    the bf16 tree (``test_torch_golden_bf16.weights_crc`` of
    ``seeded_params``), the oracle's loss, and the reference's and the
    port's CPU distances from the oracle (loss: ``loss_distances``; each
    gradient leaf: ``leaf_distances``); the batch, the six leaves and
    the bounds.  The card (``chip_smoke.py`` phase 24) holds the port's
    bf16 run there to its own float32 run by these reference distances."""
    from repro_torch.models import seeded_params
    from test_torch_golden_bf16 import weights_crc
    tc = bf16_pair(JAMBA)[2]
    nb = batch_of(tc)
    cells = {}
    for seed in SWEEP_SEEDS:
        res = loss_and_grads(JAMBA, seed)
        p, r, ol = loss_distances(res)
        cells[str(seed)] = dict(
            weights_crc32=weights_crc(seeded_params(tc, seed)),
            oracle_loss=ol, loss=[p, r], leaves=leaf_distances(res))
    return dict(arch=JAMBA, config="reduced", dtype="bfloat16",
                seeds=list(SWEEP_SEEDS), batch_seed=BATCH_SEED,
                batch={k: v.tolist() for k, v in nb.items()},
                six=list(JAMBA_SIX), ratio=RATIO, loss_floor=LOSS_FLOOR,
                grad_floor=GRAD_FLOOR, cells=cells)


def test_bf16_jamba_golden_is_this_suites():
    """``GOLDEN_JAMBA`` holds this suite's batch, seeds, six leaves and
    bounds, each seed's weights by their crc32, every leaf of the model,
    and its port distances pass ``seed_rule``."""
    import json
    from repro_torch.models import seeded_params
    from test_torch_golden_bf16 import weights_crc
    g = json.loads(GOLDEN_JAMBA.read_text())
    tc = bf16_pair(JAMBA)[2]
    assert g["batch"] == {k: v.tolist() for k, v in batch_of(tc).items()}
    assert (g["seeds"], g["six"], g["ratio"], g["loss_floor"],
            g["grad_floor"]) == (list(SWEEP_SEEDS), list(JAMBA_SIX), RATIO,
                                 LOSS_FLOOR, GRAD_FLOOR)
    names = sorted(n for n, _ in flatten(param_tree(LM(tc, device="meta"))))
    for seed in SWEEP_SEEDS:
        c = g["cells"][str(seed)]
        assert c["weights_crc32"] == weights_crc(seeded_params(tc, seed))
        assert sorted(c["leaves"]) == names
    seed_rule([g["cells"][str(s)]["leaves"] for s in SWEEP_SEEDS])


# ---------------------------------------------------- the sweeps, by hand

def _jsonl(**row) -> None:
    import json
    print(json.dumps(row), flush=True)


def sweep(seeds, depths) -> None:
    """One JSON line a (tree seed, depth) of reduced jamba: the loss's and
    every gradient leaf's (port, reference) distances from the oracle,
    the reference's per-lowering loss errors and per-token cross-entropy
    error, and the seconds it took."""
    import time
    for seed in seeds:
        for n in depths:
            t0 = time.perf_counter()
            res = loss_and_grads(JAMBA, seed, n)
            p, r, ol = loss_distances(res)
            _jsonl(seed=seed, layers=n or len(bf16_pair(JAMBA)[2]
                                              .block_pattern),
                   loss=dict(port=p, ref=r, oracle=ol,
                             limit=RATIO * r + LOSS_FLOOR * abs(ol),
                             lowerings=[abs(rl - ol)
                                        for rl, _ in res["refs"]],
                             token_ce=res["token_ce"]),
                   leaves=leaf_distances(res), s=time.perf_counter() - t0)
            if n:
                del _GRADS[(JAMBA, seed, n)]


class _RoundScores:
    """``torch`` for ``models.mamba2``, whose ``ssd_chunked`` then rounds
    its intra-chunk ``scores`` to bf16 once more."""

    def __getattr__(self, name):
        return getattr(torch, name)

    def einsum(self, eq, *ops):
        out = torch.einsum(eq, *ops)
        return (out.bfloat16().float() if eq == "bklgn,bksgn->bkgls"
                else out)


def mutants(factors) -> None:
    """One JSON line a backward fault: ``GradScale`` of B and C by each
    factor, then the extra rounding of ``scores`` (``_RoundScores``); the
    six leaves' distances at each of SWEEP_SEEDS and their medians."""
    from repro_torch.models import mamba2 as t_mamba2
    real_project, real_torch = t_mamba2._project, t_mamba2.torch

    def run(name):
        dists = [leaf_distances(loss_and_grads(JAMBA, s), port_rerun(s)[1])
                 for s in SWEEP_SEEDS]
        _jsonl(fault=name, six={k: [d[k] for d in dists] for k in JAMBA_SIX},
               medians={k: float(np.median([d[k][0] / d[k][1]
                                            for d in dists]))
                        for k in JAMBA_SIX})
    run("none")
    try:
        for f in factors:
            def faulty(p, x, cfg, f=f):
                z, xs, Bm, Cm, dt = real_project(p, x, cfg)
                return (z, xs, GradScale.apply(Bm, f),
                        GradScale.apply(Cm, f), dt)
            t_mamba2._project = faulty
            run(f"grad_scale {f}")
        t_mamba2._project = real_project
        t_mamba2.torch = _RoundScores()
        run("scores rounded to bf16")
    finally:
        t_mamba2._project, t_mamba2.torch = real_project, real_torch


def conditioning(seeds, draws: int = 3, rel: float = 2.0 ** -9) -> None:
    """One JSON line a tree seed: the port in float32 on the bf16-rounded
    tree, each weight moved by a relative uniform(-rel, rel) (half a
    bf16 step) drawn ``draws`` times, routing pinned to the oracle's:
    every leaf's distance from the oracle (median over the draws), and
    unmoved (the control)."""
    tc16 = bf16_pair(JAMBA)[2]
    tc32 = dataclasses.replace(tc16, param_dtype="float32")
    for seed in seeds:
        res = loss_and_grads(JAMBA, seed)
        m16 = LM(tc16, device="cpu")
        params_from_numpy(m16, seeded_numpy_params(tc16, seed))
        tree = tree_map(lambda leaf: np.asarray(host(leaf.numpy()),
                                                np.float32), param_tree(m16))
        runs = []
        for d in range(draws + 1):
            rng = np.random.default_rng(100 + d)
            t = tree if d == 0 else tree_map(
                lambda a: (a * (1 + rng.uniform(-rel, rel, a.shape))
                           ).astype(np.float32), tree)
            m32 = LM(tc32, device="cpu")
            params_from_numpy(m32, t)
            routing = Routing()
            routing.calls = res["experts"]
            with routing.replay("port"):
                pg = port_grads(m32, batch_of(tc32))[1]
            runs.append({k: v[0] for k, v in leaf_distances(res, pg).items()})
        _jsonl(seed=seed, control=runs[0],
               moved={k: float(np.median([r[k] for r in runs[1:]]))
                      for k in runs[0]})


if __name__ == "__main__":
    import sys
    what = sys.argv[1] if len(sys.argv) > 1 else "seeds"
    if what == "seeds":          # tree seeds 0..N-1 at full depth
        sweep(range(int(sys.argv[2]) if len(sys.argv) > 2 else 4), [0])
    elif what == "depths":       # seed 0, the block pattern cut
        sweep([SEED], [1, 2, 3, 4, 0])
    elif what == "mutants":
        mutants([float(f) for f in sys.argv[2:]] or [1.1, 1.25, 1.5, 2.0])
    elif what == "conditioning":
        conditioning(range(int(sys.argv[2]) if len(sys.argv) > 2 else 4))
    elif what == "golden":
        import json
        GOLDEN_JAMBA.write_text(json.dumps(jamba_golden(), indent=1) + "\n")
        print(f"wrote {GOLDEN_JAMBA}")
    else:
        sys.exit(f"unknown {what!r}: seeds [N] | depths | mutants "
                 f"[factor ...] | conditioning [N] | golden")
