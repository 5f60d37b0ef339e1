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
leaf (through the port's flash backward plain version), but the six
leaves of ROADMAP §C 12, which a test of their own pins.  Where a family
routes tokens to experts, the bf16 runs take the oracle's experts
(``Routing``: teacher-forced routing), and the port's own top-k equals
the oracle's on every token whose margin exceeds the bf16 gate error
(``check_routing``).  Seeds are the suite's: the tree 0, the batch 1."""
import dataclasses

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

ARCHS = sorted(t_configs.ALL_ARCHS)


def bf16_pair(arch: str):
    """(reference bf16, reference f32, port bf16) reduced configs."""
    jc = j_configs.get(arch).reduced()
    return (dataclasses.replace(jc, param_dtype="bfloat16"), jc,
            dataclasses.replace(t_configs.get(arch).reduced(),
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

    def __init__(self, arch: str, seed: int = SEED):
        jc16, jc32, tc = bf16_pair(arch)
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


def family(arch: str) -> Family:
    if arch not in _FAMILIES:
        _FAMILIES.clear()               # one family's trees at a time
        _FAMILIES[arch] = Family(arch)
    return _FAMILIES[arch]


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


# ROADMAP §C 12 (open): reduced jamba's bf16 gradients of layer 0's B and
# C projections and, through them, its ln1 and the embedding sit 1.8-3.3
# (relative Frobenius) from the oracle in the port, 0.39-0.54 in the
# reference, with the routing pinned; the same leaves of one Mamba2 block
# alone hold the oracle better than the reference's (0.006-0.019).  They
# are held by test_bf16_jamba_layer0_gradient_fault_is_pinned, not by the
# bound, until the fault is found.
JAMBA_FAULT = ("blocks/l0/ln1", "blocks/l0/mixer/conv_B",
               "blocks/l0/mixer/conv_C", "blocks/l0/mixer/w_B",
               "blocks/l0/mixer/w_C", "embed")
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


def loss_and_grads(arch: str) -> dict:
    """The loss and every gradient leaf of the oracle, of the reference's
    two bf16 lowerings and of the port (routing pinned for an MoE
    family), with the reference's per-token cross-entropy distance; kept
    for the family's later tests.  The oracle runs without remat (the
    same numbers), so that each MoE call is recorded once."""
    if arch in _GRADS:
        return _GRADS[arch]
    fam = family(arch)
    cfg = fam.cfg
    nb = batch_of(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    (jm16, jp16), (jm32, jp32) = fam.ref, fam.oracle
    routing = check_routing(fam, nb, arch) if cfg.num_experts else None
    t_att.reset_launches()
    ((ol, o32), og), refs, (pl, pg) = three_runs(
        fam, lambda: jit16(loss_with_logits(jm32, False), {})(jp32, jb),
        lambda opt: jit16(loss_with_logits(jm16, True), opt)(jp16, jb),
        lambda: port_grads(fam.port, nb))
    backward_runs = t_att.plain_runs["flash_attention_backward"]
    ce_o = token_ce(o32, nb["targets"])
    _GRADS[arch] = dict(
        oracle=(float(ol), ref_paths(og)),
        refs=[(float(rl), ref_paths(g)) for (rl, _), g in refs],
        port=(pl, pg), backward_runs=backward_runs, routing=routing,
        token_ce=[float(np.abs(token_ce(r, nb["targets"]) - ce_o).mean())
                  for (_, r), _ in refs])
    return _GRADS[arch]
    fam = family(arch)
    cfg = fam.cfg
    nb = batch_of(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    (jm16, jp16), (jm32, jp32) = fam.ref, fam.oracle
    routing = check_routing(fam, nb, arch) if cfg.num_experts else None
    ol, og = jax.jit(jax.value_and_grad(jm32.loss))(jp32, jb)
    t_att.reset_launches()
    o32, grads, (pl, pg) = three_runs(
        fam, lambda: jit16(jm32.forward, {})(jp32, jb),
        lambda opt: jit16(jax.value_and_grad(jm16.loss), opt)(jp16, jb),
        lambda: port_grads(fam.port, nb))
    backward_runs = t_att.plain_runs["flash_attention_backward"]
    r16 = three_runs(fam, lambda: jit16(jm32.forward, {})(jp32, jb),
                     lambda opt: jit16(jm16.forward, opt)(jp16, jb),
                     None)[1]
    ce_o = token_ce(o32, nb["targets"])
    _GRADS[arch] = dict(
        oracle=(float(ol), ref_paths(og)),
        refs=[(float(rl), ref_paths(g)) for rl, g in grads],
        port=(pl, pg), backward_runs=backward_runs, routing=routing,
        token_ce=[float(np.abs(token_ce(r, nb["targets"]) - ce_o).mean())
                  for r in r16])
    return _GRADS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_hold_the_oracle(arch):
    """The loss: the reference's bf16 distance is the larger of its loss's
    and its tokens' mean |cross-entropy - oracle's| (a mean of signed
    per-token errors cancels by chance: seamless's reference loss came
    3.0e-5 from the oracle with per-token errors of std 1.2e-3).  Every
    gradient leaf under the bound, but jamba's six of ROADMAP §C 12."""
    res = loss_and_grads(arch)
    ol, want = res["oracle"]
    pl, pg = res["port"]
    assert pl.dtype == torch.float32 and pl.dim() == 0
    pl = float(pl.detach())
    r_dist = max([abs(rl - ol) for rl, _ in res["refs"]] + res["token_ce"])
    assert abs(pl - ol) <= RATIO * r_dist + LOSS_FLOOR * abs(ol), (
        f"{arch}: loss {pl} (the reference's distance {r_dist:.3g}, "
        f"oracle {ol})")
    refs = [g for _, g in res["refs"]]
    assert sorted(pg) == sorted(want) == sorted(refs[0])
    skip = JAMBA_FAULT if arch == "jamba-1.5-large-398b" else ()
    for k in want:
        assert pg[k].shape == want[k].shape, k
        if k in skip:
            continue
        p_err = rel_fro(pg[k], want[k])
        r_err = max(rel_fro(f64(r[k]), want[k]) for r in refs)
        assert p_err <= RATIO * r_err + GRAD_FLOOR, (
            f"{arch} {k}: gradient {p_err:.4g} from the oracle, the "
            f"reference's {r_err:.4g}")
    has_attn = any(s.mixer == "attn" for s in family(arch).port.specs)
    assert (res["backward_runs"] > 0) == has_attn


def test_bf16_jamba_layer0_gradient_fault_is_pinned():
    """ROADMAP §C 12: the six leaves of JAMBA_FAULT each further than
    RATIO x the reference's distance from the oracle.  When this fails,
    the fault is fixed: hold the leaves to the bound again."""
    res = loss_and_grads("jamba-1.5-large-398b")
    want = res["oracle"][1]
    pg = res["port"][1]
    for k in JAMBA_FAULT:
        p_err = rel_fro(pg[k], want[k])
        r_err = max(rel_fro(f64(g[k]), want[k]) for _, g in res["refs"])
        assert p_err > RATIO * r_err + GRAD_FLOOR, (k, p_err, r_err)


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
