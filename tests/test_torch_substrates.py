"""The port's model families module by module (``repro_torch.models``:
``moe``, ``mamba2``, MLA, cross-attention and M-RoPE in ``attention`` and
``layers``, the decode kernel's soft cap) against the reference's
(``repro.models``), with the same weights (``seeded_numpy_params``) and
inputs from a numpy seed; the reference behaviours the port keeps on
purpose (ROADMAP §C); the parameter trees of all ten architectures; and
the serving engine on each new family.

Tolerance: rtol = atol = 1e-4 on activations and logits, as
tests/test_torch_models.py; MoE routing, capacity drops per expert,
greedy tokens and the engine's reports identical.  The port runs with
``device="cpu"`` (the kernels' plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import mamba2 as j_mamba  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels import attention as t_kattn  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mamba2 as t_mamba  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import weights as t_w  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def pair(arch, **kw):
    """(reference, port) reduced configs of ``arch``, with overrides."""
    return tuple(dataclasses.replace(m.get(arch).reduced(), **kw)
                 for m in (j_configs, t_configs))


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def ttree(tree):
    return {k: ttree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def layer_params(cfg, li, seed=0):
    tree = t_w.seeded_numpy_params(cfg, seed)
    where, i = t_w.layer_source(cfg, li)
    if where == "prefix":
        return tree["prefix"][i]
    return jax.tree_util.tree_map(lambda a: a[i], tree["blocks"][where])


# --------------------------------------------------------------------- MoE

def ref_drops(p, x2, cfg) -> np.ndarray:
    """Dropped (token, slot) pairs per expert of the reference's
    ``_moe_mlp_dense`` routing (its own lines, on its own gates)."""
    t = x2.shape[0]
    gates = jax.nn.softmax(x2.astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(gates, cfg.top_k)
    e_flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, cfg.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              e_flat[:, None], axis=1)[:, 0]
    keep = pos < j_moe._capacity(t, cfg)
    return np.bincount(np.asarray(e_flat)[~np.asarray(keep)],
                       minlength=cfg.num_experts)


@pytest.mark.parametrize("arch,tokens,factor", [
    ("deepseek-moe-16b", 24, None), ("deepseek-moe-16b", 200, 0.5),
    ("deepseek-moe-16b", 7, None), ("deepseek-v2-lite-16b", 200, None),
    ("jamba-1.5-large-398b", 64, None)])
def test_moe_mlp_matches_reference_with_its_drops(arch, tokens, factor):
    """``moe_mlp`` against the reference's, and the dropped pairs counted
    per expert against the reference's routing (a capacity factor of 0.5
    makes deepseek-moe drop; deepseek-v2-lite is dropless)."""
    kw = {} if factor is None else {"capacity_factor": factor}
    jc, tc = pair(arch, **kw)
    li = next(i for i, s in enumerate(t_w.layer_specs(tc)) if s.mlp == "moe")
    p = layer_params(tc, li)["mlp"]
    x = np.random.default_rng(tokens).standard_normal(
        (2, tokens // 2 or 1, tc.d_model), np.float32)
    if tokens % 2:
        x = x.reshape(1, -1, tc.d_model)[:, :tokens]
    jy = j_moe.moe_mlp(jtree(p), jnp.asarray(x), jc)
    ty = t_moe.moe_mlp(ttree(p), torch.from_numpy(x), tc)
    np.testing.assert_allclose(np32(ty), np32(jy), **TOL)
    x2 = x.reshape(-1, tc.d_model)
    assert t_moe._capacity(len(x2), tc) == j_moe._capacity(len(x2), jc)
    r = t_moe.route(ttree(p), torch.from_numpy(x2), tc)
    drops = np.bincount(r.expert[~r.keep].numpy(), minlength=tc.num_experts)
    np.testing.assert_array_equal(drops, ref_drops(jtree(p),
                                                   jnp.asarray(x2), jc))
    if tc.capacity_factor <= 0:
        assert drops.sum() == 0                      # dropless
    elif factor is not None:
        assert drops.sum() > 0                       # the drops ran


def test_moe_routing_ties_go_to_the_lower_expert():
    """Equal gates (a zero router) route to experts 0..k-1, as
    ``lax.top_k`` does, with weights 1/k."""
    jc, tc = pair("deepseek-moe-16b")
    p = layer_params(tc, 1)["mlp"]
    p["router"] = np.zeros_like(p["router"])
    x2 = np.random.default_rng(0).standard_normal((5, tc.d_model),
                                                  np.float32)
    r = t_moe.route(ttree(p), torch.from_numpy(x2), tc)
    _, jidx = jax.lax.top_k(jnp.full((5, tc.num_experts), 0.125), tc.top_k)
    np.testing.assert_array_equal(r.expert.numpy(),
                                  np.asarray(jidx).reshape(-1))
    np.testing.assert_allclose(r.weight.numpy(), 1.0 / tc.top_k)
    np.testing.assert_allclose(
        np32(t_moe.moe_mlp(ttree(p), torch.from_numpy(x2), tc)),
        np32(j_moe.moe_mlp(jtree(p), jnp.asarray(x2), jc)), **TOL)


def test_moe_capacity_drops_depend_on_the_batch():
    """ROADMAP §C (kept on purpose): with capacity drops a token's output
    depends on the other tokens of the call, in both packages."""
    jc, tc = pair("deepseek-moe-16b", capacity_factor=0.25)
    p = layer_params(tc, 1)["mlp"]
    x = np.random.default_rng(3).standard_normal((1, 64, tc.d_model),
                                                 np.float32)
    full = np32(t_moe.moe_mlp(ttree(p), torch.from_numpy(x), tc))[0, -1]
    alone = np32(t_moe.moe_mlp(ttree(p), torch.from_numpy(x[:, -1:]), tc))
    jfull = np32(j_moe.moe_mlp(jtree(p), jnp.asarray(x), jc))[0, -1]
    np.testing.assert_allclose(full, jfull, **TOL)
    assert np.abs(full - alone[0, 0]).max() > 1e-3


@pytest.mark.parametrize("arch,tokens,factor", [
    ("deepseek-moe-16b", 8, None), ("deepseek-moe-16b", 32, 0.25),
    ("deepseek-v2-lite-16b", 7, None), ("jamba-1.5-large-398b", 16, None)])
def test_moe_mlp_grouped_path_matches_reference(monkeypatch, arch, tokens,
                                                factor):
    """``moe_mlp`` on its grouped path (``grouped_path`` forced on; on the
    CPU ``kernels.moe.grouped_experts`` runs its plain version) against the
    reference's, on a decode step's tokens (a capacity factor of 0.25
    makes deepseek-moe drop)."""
    from repro_torch.kernels import moe as t_kmoe
    kw = {} if factor is None else {"capacity_factor": factor}
    jc, tc = pair(arch, **kw)
    li = next(i for i, s in enumerate(t_w.layer_specs(tc)) if s.mlp == "moe")
    p = layer_params(tc, li)["mlp"]
    x = np.random.default_rng(tokens).standard_normal(
        (tokens, 1, tc.d_model), np.float32)
    monkeypatch.setattr(t_moe, "grouped_path", lambda *a: True)
    t_kmoe.reset_launches()
    with torch.no_grad():
        ty = t_moe.moe_mlp(ttree(p), torch.from_numpy(x), tc)
    assert t_kmoe.plain_runs["grouped_experts"] == 1
    jy = j_moe.moe_mlp(jtree(p), jnp.asarray(x), jc)
    np.testing.assert_allclose(np32(ty), np32(jy), **TOL)
    r = t_moe.route(ttree(p), torch.from_numpy(x.reshape(tokens, -1)), tc)
    assert (int((~r.keep).sum()) > 0) == (factor is not None)


# ------------------------------------------------------------------ Mamba2

def ssd_inputs(seed, b=2, s=48, h=4, p=8, g=2, n=6):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, h, p), np.float32),
            np.log1p(np.exp(r.standard_normal((b, s, h), np.float32))),
            -np.exp(r.standard_normal(h, np.float32) * 0.5),
            r.standard_normal((b, s, g, n), np.float32),
            r.standard_normal((b, s, g, n), np.float32),
            r.standard_normal((b, h, p, n), np.float32))


@pytest.mark.parametrize("chunk,with_state", [(8, False), (16, True),
                                              (48, True), (1, False)])
def test_ssd_chunked_equals_its_oracles_and_the_reference(chunk, with_state):
    """``ssd_chunked`` == ``ssd_chunked_seq`` == the ``ssd_step``
    recurrence on the port, and == the reference's ``ssd_chunked``."""
    x, dt, A, B, C, s0 = ssd_inputs(chunk)
    init = s0 if with_state else None
    targs = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    tinit = torch.from_numpy(s0) if with_state else None
    y, final = t_mamba.ssd_chunked(*targs, chunk=chunk, init_state=tinit)
    ys, finals = t_mamba.ssd_chunked_seq(*targs, chunk=chunk,
                                         init_state=tinit)
    np.testing.assert_allclose(np32(ys), np32(y), **TOL)
    np.testing.assert_allclose(np32(finals), np32(final), **TOL)
    state = torch.from_numpy(s0 if with_state else np.zeros_like(s0))
    steps = []
    for t in range(x.shape[1]):
        yt, state = t_mamba.ssd_step(state, targs[0][:, t], targs[1][:, t],
                                     targs[2], targs[3][:, t],
                                     targs[4][:, t])
        steps.append(yt)
    np.testing.assert_allclose(np32(torch.stack(steps, 1)), np32(y), **TOL)
    np.testing.assert_allclose(np32(state), np32(final), **TOL)
    jy, jfinal = j_mamba.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
        init_state=None if init is None else jnp.asarray(init))
    np.testing.assert_allclose(np32(y), np32(jy), **TOL)
    np.testing.assert_allclose(np32(final), np32(jfinal), **TOL)


@pytest.mark.parametrize("s", [1, 2, 3, 5])
def test_mamba_short_prompt_conv_cache_matches_reference(s):
    """ROADMAP §C (kept on purpose): a prompt shorter than conv_width - 1
    (3) leaves the conv history as it was; then decode continues from
    it, in both packages."""
    jc, tc = pair("mamba2-780m")
    p = layer_params(tc, 0)["mixer"]
    r = np.random.default_rng(s)
    x = r.standard_normal((2, s, tc.d_model), np.float32)
    conv0 = r.standard_normal((2, tc.conv_width - 1,
                               tc.d_inner + 2 * tc.ssm_groups * tc.ssm_state),
                              np.float32)
    jcache = {"conv": jnp.asarray(conv0),
              "ssm": jnp.zeros((2, tc.ssm_heads, tc.ssm_head_dim,
                                tc.ssm_state))}
    tcache = t_mamba.init_mamba_cache(tc, 2, torch.float32, "cpu")
    tcache["conv"].copy_(torch.from_numpy(conv0))
    jy, jcache = j_tf._mamba_prefill(jtree(p), jnp.asarray(x), jcache, jc)
    ty, tcache = t_mamba.mamba_prefill(ttree(p), torch.from_numpy(x), tcache,
                                       tc)
    np.testing.assert_allclose(np32(ty), np32(jy), **TOL)
    for f in ("conv", "ssm"):
        np.testing.assert_allclose(np32(tcache[f]), np32(jcache[f]), **TOL)
    if s < tc.conv_width - 1:
        np.testing.assert_array_equal(tcache["conv"].numpy(), conv0)
    xn = r.standard_normal((2, 1, tc.d_model), np.float32)
    jy, _ = j_mamba.mamba_decode_step(jtree(p), jnp.asarray(xn), jcache, jc)
    ty, _ = t_mamba.mamba_decode_step(ttree(p), torch.from_numpy(xn), tcache,
                                      tc)
    np.testing.assert_allclose(np32(ty), np32(jy), **TOL)


def test_bf16_jamba_keeps_its_f32_leaves():
    """A bf16 jamba-reduced LM makes the router, ``A_log`` and ``dt_bias``
    float32 and everything else bf16, as the reference's ``init`` does,
    and runs forward, prefill and decode to finite f32 logits held to the
    reference's by tests/test_torch_bf16.py's bound: each no further from
    the f32 oracle (the reference in f32 on the rounded weights) than 2 x
    the reference's bf16 run (the larger of its two XLA lowerings) plus
    1e-3 x max |oracle|, with the routing of both bf16 runs pinned to the
    oracle's.  bf16 rounding through 8 layers of Mamba2 and top-2 routing
    moves single logits far (the reference's bf16 run comes 7-35 % of the
    largest logit from the oracle here), so the bound is on each package's
    distance from the oracle, not between the two."""
    from test_torch_bf16 import LOWERINGS, family, jit16, three_runs, within
    jc, tc = pair("jamba-1.5-large-398b", param_dtype="bfloat16")
    tm = LM(tc, device="cpu")
    ref = j_tf.LM(jc).init(jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(k): str(v.dtype) for k, v in
            jax.tree_util.tree_leaves_with_path(ref)}
    tree = t_w.seeded_numpy_params(tc, 0)
    t_w.params_from_numpy(tm, tree)
    got = {jax.tree_util.keystr(k): str(v.dtype) for k, v in
           jax.tree_util.tree_leaves_with_path(t_w.params_to_numpy(tm))}
    assert sorted(got) == sorted(want)
    f32 = {n for n, d in want.items() if d == "float32"}
    assert f32 and all(any(leaf in n for leaf in ("router", "A_log",
                                                  "dt_bias")) for n in f32)
    for li, layer in enumerate(tm.layers):
        for name, param in layer.named_parameters():
            keep = name.split(".")[-1] in ("router", "A_log", "dt_bias")
            assert param.dtype == (torch.float32 if keep
                                   else torch.bfloat16), (li, name)
    fam = family("jamba-1.5-large-398b")     # the same weights (seed 0)
    (jm16, jp16), (jm32, jp32), tm = fam.ref, fam.oracle, fam.port
    tokens = np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 16)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(
        tokens)}
    o, r, p = three_runs(fam, lambda: jit16(jm32.forward, {})(jp32, jb),
                         lambda opt: jit16(jm16.forward, opt)(jp16, jb),
                         lambda: tm(tb))
    outs = [(p, r, o, "forward")]
    (ol, oc), rs, (pl, pc) = three_runs(
        fam, lambda: jax.jit(jm32.prefill)(jp32, jb, jm32.init_caches(2, 20)),
        lambda opt: jit16(jm16.prefill, opt)(jp16, jb,
                                             jm16.init_caches(2, 20)),
        lambda: tm.prefill(tb, tm.init_caches(2, 20)))
    outs.append((pl, [x[0] for x in rs], ol, "prefill"))
    rcs = [x[1] for x in rs]
    tok = jnp.asarray(tokens[:, 0])
    (ol, _), rs, (pl, _) = three_runs(
        fam, lambda: jax.jit(jm32.decode_step)(jp32, tok, oc, jnp.int32(16)),
        lambda opt: jit16(jm16.decode_step, opt)(
            jp16, tok, rcs[LOWERINGS.index(opt)], jnp.int32(16)),
        lambda: tm.decode_step(torch.from_numpy(tokens[:, 0]), pc, 16))
    outs.append((pl, [x[0] for x in rs], ol, "step"))
    for p, r, o, what in outs:
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), what
        within(p, r, o, 1e-3, f"jamba bf16 {what}")


# --------------------------------------------------------------- attention

def test_project_mla_matches_reference():
    jc, tc = pair("deepseek-v2-lite-16b")
    p = layer_params(tc, 1)["mixer"]
    x = np.random.default_rng(0).standard_normal((2, 9, tc.d_model),
                                                 np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32) + 3, (2, 1))
    ja = j_attn._angles(jc, jnp.asarray(pos))
    ta = t_attn._angles(tc, torch.from_numpy(pos))
    np.testing.assert_allclose(np32(ta), np32(ja), **TOL)
    for got, want in zip(t_attn._project_mla(ttree(p), torch.from_numpy(x),
                                             tc, ta),
                         j_attn._project_mla(jtree(p), jnp.asarray(x), jc,
                                             ja)):
        assert got.shape == want.shape
        np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_absorbed_mla_decode_equals_attention_over_the_decompressed_cache():
    """The absorbed latent-space decode against the reference's, and
    against plain attention of the new token over the decompressed K/V
    of the whole prefix (its algebraic twin)."""
    jc, tc = pair("deepseek-v2-lite-16b")
    spec = t_w.layer_specs(tc)[1]
    p = layer_params(tc, 1)["mixer"]
    r = np.random.default_rng(1)
    s = 10
    x = r.standard_normal((2, s + 1, tc.d_model), np.float32)
    tcache = t_attn.init_kv_cache(tc, spec, 2, 16, torch.float32, "cpu")
    jcache = j_attn.init_kv_cache(jc, spec, 2, 16, jnp.float32)
    t_attn.prefill_into_cache(ttree(p), torch.from_numpy(x[:, :s]), tcache,
                              tc, spec)
    _, jcache = j_attn.prefill_into_cache(jtree(p), jnp.asarray(x[:, :s]),
                                          jcache, jc, spec)
    ty, tcache = t_attn.decode_attention(ttree(p), torch.from_numpy(
        x[:, s:]), tcache, s, tc, spec)
    jy, jcache = j_attn.decode_attention(jtree(p), jnp.asarray(x[:, s:]),
                                         jcache, jnp.int32(s), jc, spec)
    np.testing.assert_allclose(np32(ty), np32(jy), **TOL)
    for f in ("c_kv", "k_rope"):
        np.testing.assert_allclose(np32(tcache[f]), np32(jcache[f]), **TOL)
    full = t_attn.attention(ttree(p), torch.from_numpy(x), tc, spec,
                            torch.arange(s + 1).expand(2, s + 1))
    np.testing.assert_allclose(np32(ty), np32(full[:, -1:]), **TOL)


@pytest.mark.parametrize("t_enc,s", [(7, 5), (16, 1)])
def test_cross_attention_matches_reference(t_enc, s):
    jc, tc = pair("seamless-m4t-medium")
    p = layer_params(tc, 0)["xattn"]
    r = np.random.default_rng(t_enc)
    enc = r.standard_normal((2, t_enc, tc.d_model), np.float32)
    x = r.standard_normal((2, s, tc.d_model), np.float32)
    tkv = t_attn.encode_cross_kv(ttree(p), torch.from_numpy(enc), tc)
    jkv = j_attn.encode_cross_kv(jtree(p), jnp.asarray(enc), jc)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(np32(a), np32(b), **TOL)
    np.testing.assert_allclose(
        np32(t_attn.cross_attention(ttree(p), torch.from_numpy(x), tkv, tc)),
        np32(j_attn.cross_attention(jtree(p), jnp.asarray(x), jkv, jc)),
        **TOL)


@pytest.mark.parametrize("sections,theta", [((4, 2, 2), 1e6),
                                            ((16, 24, 24), 1e6),
                                            ((2, 3, 3), 1e4)])
def test_mrope_angles_match_reference(sections, theta):
    hd = 2 * sum(sections)
    r = np.random.default_rng(hd)
    pos = r.integers(0, 5000, (3, 2, 7)).astype(np.int32)
    got = t_layers.mrope_angles(torch.from_numpy(pos), hd, theta, sections)
    want = j_layers.mrope_angles(jnp.asarray(pos), hd, theta, sections)
    assert got.shape == (2, 7, hd // 2)
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-6, atol=1e-3)
    same = np.broadcast_to(pos[:1], pos.shape).copy()   # equal streams:
    np.testing.assert_allclose(                         # plain RoPE
        np32(t_layers.mrope_angles(torch.from_numpy(same), hd, theta,
                                   sections)),
        np32(t_layers.rope_angles(torch.from_numpy(same[0]), hd, theta)),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sum"):
        t_layers.mrope_angles(torch.from_numpy(pos), hd + 2, theta, sections)


def test_mrope_only_in_forward():
    """ROADMAP §C (kept on purpose): qwen2-vl's ``prefill`` ignores
    ``positions`` and rotates by ``arange(S)``, in both packages, while
    ``forward`` reads them."""
    jc, tc = pair("qwen2-vl-7b")
    tree = t_w.seeded_numpy_params(tc, 0)
    tm = LM(tc, device="cpu")
    t_w.params_from_numpy(tm, tree)
    jm = j_tf.LM(jc)
    r = np.random.default_rng(0)
    tokens = r.integers(0, tc.vocab_size, (2, 8)).astype(np.int32)
    t = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    positions = np.stack([t, t // 2, t % 3 + 5])
    tb = {"tokens": torch.from_numpy(tokens)}
    tbp = {**tb, "positions": torch.from_numpy(positions)}
    plain, _ = tm.prefill(tb, tm.init_caches(2, 8))
    with_pos, _ = tm.prefill(tbp, tm.init_caches(2, 8))
    assert torch.equal(plain, with_pos)
    jl, _ = jm.prefill(jtree(tree), {"tokens": jnp.asarray(tokens),
                                     "positions": jnp.asarray(positions)},
                       jm.init_caches(2, 8))
    np.testing.assert_allclose(np32(with_pos), np32(jl), **TOL)
    fwd = tm(tbp)[:, -1]
    assert float((fwd - tm(tb)[:, -1]).abs().max()) > 1e-3
    np.testing.assert_allclose(
        np32(fwd), np32(jm.forward(jtree(tree), {
            "tokens": jnp.asarray(tokens),
            "positions": jnp.asarray(positions)})[:, -1]), **TOL)


@pytest.mark.parametrize("cap,g", [(50.0, 2), (30.0, 1), (5.0, 4)])
def test_soft_capped_decode_plain_matches_the_reference_sdpa(cap, g):
    """The decode kernel's plain version with a soft cap against the
    reference model's ``_sdpa`` (scale, cap, then mask)."""
    jc, _ = pair("gemma2-9b", logit_softcap=cap)
    r = np.random.default_rng(int(cap))
    b, kvh, hd, t = 2, 2, 16, 23
    q = 3 * r.standard_normal((b, kvh * g, hd), np.float32)
    k = 3 * r.standard_normal((b, t, kvh, hd), np.float32)
    v = r.standard_normal((b, t, kvh, hd), np.float32)
    valid = r.random((b, t)) < 0.7
    valid[1] = False                         # a row with no valid key
    got = t_kattn.decode_attention(*map(torch.from_numpy, (q, k, v, valid)),
                                   softcap=cap)
    want = j_attn._sdpa(jnp.asarray(q[:, None]), jnp.asarray(k),
                        jnp.asarray(v), jnp.asarray(valid[:, None, :]), jc)
    np.testing.assert_allclose(np32(got), np32(want)[:, 0], **TOL)
    uncapped = t_kattn.decode_attention(*map(torch.from_numpy,
                                             (q, k, v, valid)))
    assert float((got - uncapped).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="softcap"):
        t_kattn.decode_attention(*map(torch.from_numpy, (q, k, v, valid)),
                                 softcap=-1.0)


# ------------------------------------------------------- parameter trees

@pytest.mark.parametrize("arch", sorted(t_configs.ALL_ARCHS))
def test_seeded_tree_has_the_reference_structure_and_round_trips(arch):
    """``seeded_numpy_params`` builds the reference's own tree (structure,
    shapes) for every architecture; it loads into the port and comes back
    unchanged, and it loads into the reference's LM."""
    jc, tc = pair(arch)
    tree = t_w.seeded_numpy_params(tc, 7)
    ref = j_tf.LM(jc).init(jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(jtree(tree))
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape
    tm = LM(tc, device="cpu")
    t_w.params_from_numpy(tm, tree)
    back = dict(jax.tree_util.tree_leaves_with_path(t_w.params_to_numpy(tm)))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(back[path], a, err_msg=str(path))
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", ["mamba2-780m", "deepseek-moe-16b",
                                  "seamless-m4t-medium"])
def test_init_weights_draws_the_reference_distributions(arch):
    tc = t_configs.get(arch).reduced()
    tm = LM(tc, device="cpu").init_weights(torch.Generator().manual_seed(0))
    for p, init in tm._leaves():
        if init.scale is None:
            assert bool((p == 1).all())
        elif init.scale == 0:
            assert bool((p == 0).all())
        elif p.numel() >= 4096:
            assert abs(float(p.std()) - init.scale) < 0.1 * init.scale


# ------------------------------------------------------- serving engine

@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "mamba2-780m",
                                  "deepseek-v2-lite-16b", "gemma2-9b",
                                  "qwen2-vl-7b"])
def test_engine_serves_each_family_as_the_reference(arch):
    """``Engine.run`` on the reduced config of each new family (the
    encoder-decoder branch with its zero frames included): the same
    tokens and reports as the reference's engine, then the same prompts
    again (pages reused) and Morpheus off, with the same tokens."""
    jc, tc = pair(arch)
    tree = t_w.seeded_numpy_params(tc, 0)
    prompts = np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 32)).tolist()
    j_eng = JEngine(j_tf.LM(jc), jtree(tree), max_len=48)
    t_eng = Engine(LM(tc, device="cpu"), tree, max_len=48)
    off = Engine(t_eng.model, max_len=48, morpheus=False)
    tokens = []
    for run in range(2):
        jr = [JRequest(i, p, 5) for i, p in enumerate(prompts)]
        tr = [Request(i, p, 5) for i, p in enumerate(prompts)]
        j_rep, t_rep = j_eng.run(jr), t_eng.run(tr)
        assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
        a, b = dataclasses.asdict(j_rep), dataclasses.asdict(t_rep)
        assert abs(a.pop("modeled_time_ns") - b.pop("modeled_time_ns")) <= \
            1e-3 * max(abs(j_rep.modeled_time_ns), 1.0)
        assert a == b
        tokens.append([r.out_tokens for r in tr])
    assert t_rep.pages_reused > 0
    tr = [Request(i, p, 5) for i, p in enumerate(prompts)]
    off.run(tr)
    assert [r.out_tokens for r in tr] == tokens[0] == tokens[1]
