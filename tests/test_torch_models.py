"""The port's model substrates (``repro_torch.configs``, ``.models``)
against the reference's (``repro.configs``, ``repro.models``), with the
same weights (``seeded_numpy_params``) and inputs from a numpy seed, on
the ``reduced()`` config of each of the ten architectures (and a
sliding-window variant of qwen3).  The port runs with ``device="cpu"``,
i.e. the attention kernels' plain versions; the reference runs its jnp
attention.

Tolerance: rtol = atol = 1e-4 on activations, caches and logits (f32
sums in another order, and XLA's and PyTorch's own pow, sin and cos);
greedy tokens, cache positions and the config registry are identical."""
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
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mamba2 as t_mamba  # noqa: E402
from repro_torch.models import weights as t_w  # noqa: E402
from repro_torch.models import LM, build_model  # noqa: E402
from repro_torch.serving import sampler as t_sampler  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def local_variant(m):
    """A 2-layer (LOCAL, GLOBAL) variant of the reduced qwen3 (from config
    module ``m``) with window 8: ring caches and the decode window mask,
    which qwen3 never exercises."""
    base = m.get("qwen3-4b").reduced()
    return dataclasses.replace(base, name=base.name + "-local",
                               block_pattern=(m.LOCAL, m.GLOBAL),
                               num_layers=2, window=8)


def reduced(arch):
    return lambda m: m.get(arch).reduced()


CONFIGS = {
    "qwen3-reduced": reduced("qwen3-4b"),
    "qwen3-local": local_variant,
    **{f"{a}-reduced": reduced(a) for a in (
        "seamless-m4t-medium", "h2o-danube-1.8b", "gemma2-9b", "gemma3-27b",
        "qwen2-vl-7b", "jamba-1.5-large-398b", "deepseek-v2-lite-16b",
        "deepseek-moe-16b", "mamba2-780m")},
}


def pair(name):
    return CONFIGS[name](j_configs), CONFIGS[name](t_configs)


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def ttree(tree):
    return {k: ttree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def layer_tree(tree, cfg, li):
    where, i = t_w.layer_source(cfg, li)
    if where == "prefix":
        return tree["prefix"][i]
    return jax.tree_util.tree_map(lambda a: a[i], tree["blocks"][where])


def ref_layer_caches(caches, cfg):
    """The reference's (prefix list, stacked blocks) caches per layer."""
    out = list(caches["prefix"])
    pat = len(cfg.block_pattern)
    for blk in range(cfg.num_blocks):
        for i in range(pat):
            out.append(jax.tree_util.tree_map(
                lambda a: a[blk], caches["blocks"][f"l{i}"]))
    return out


def assert_caches_equal(ref, port):
    """Every field of every layer's cache: positions identical, K/V, MLA
    latents and Mamba2 conv and SSM states within TOL."""
    assert len(ref) == len(port)
    for li, (r, p) in enumerate(zip(ref, port)):
        assert sorted(r) == sorted(p), f"layer {li}"
        for f in r:
            if f == "pos":
                np.testing.assert_array_equal(np.asarray(r[f]), p[f].numpy(),
                                              err_msg=f"layer {li} pos")
            else:
                np.testing.assert_allclose(np32(p[f]), np32(r[f]), **TOL,
                                           err_msg=f"layer {li} {f}")


def extra_inputs(cfg, b, s, r):
    """The optional batch inputs a family reads, from the numpy generator
    ``r``: the encoder's frames of an encoder-decoder arch; a vision
    prefix of 3 patches and three distinct t/h/w position streams for
    M-RoPE (``forward`` alone reads the positions)."""
    out = {}
    if cfg.is_encdec:
        out["frame_embeds"] = r.standard_normal((b, 5, cfg.d_model),
                                                np.float32)
    if cfg.mrope_sections is not None:
        out["patch_embeds"] = 0.1 * r.standard_normal((b, 3, cfg.d_model),
                                                      np.float32)
        t = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        out["positions"] = np.stack([t, t // 2, t % 3 + 5])
    return out


# ----------------------------------------------------------------- configs

def test_configs_are_a_copy_of_the_reference():
    assert sorted(t_configs.ALL_ARCHS) == sorted(j_configs.ALL_ARCHS)
    for name, jc in j_configs.ALL_ARCHS.items():
        tc = t_configs.get(name)
        for a, b in ((jc, tc), (jc.reduced(), tc.reduced())):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert a.param_count() == b.param_count()
            assert a.padded_vocab() == b.padded_vocab()
            assert a.num_blocks == b.num_blocks
    assert t_configs.SHAPES == {
        k: t_configs.ShapeConfig(**dataclasses.asdict(v))
        for k, v in j_configs.SHAPES.items()}
    full = t_configs.get("qwen3-4b")
    assert full.param_count()[0] == 4_022_784_000
    assert full.padded_vocab() == 152_064


# ------------------------------------------------------------------ layers

def test_layers_match_reference():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 3, 16), np.float32)
    w = r.standard_normal(16, np.float32)
    np.testing.assert_allclose(
        np32(t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        np32(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    pos = np.tile(np.arange(5, dtype=np.int32) + 37, (2, 1))
    for theta in (10_000.0, 1_000_000.0):
        ja = j_layers.rope_angles(jnp.asarray(pos), 16, theta)
        ta = t_layers.rope_angles(torch.from_numpy(pos), 16, theta)
        np.testing.assert_allclose(np32(ta), np32(ja), **TOL)
        np.testing.assert_allclose(
            np32(t_layers.apply_rope(torch.from_numpy(x), ta)),
            np32(j_layers.apply_rope(jnp.asarray(x), ja)), **TOL)
    h = r.standard_normal((2, 5, 16), np.float32)
    mlp = {k: r.standard_normal(s, np.float32) * 0.2
           for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)),
                        ("w_down", (24, 16)))}
    for act in ("silu", "gelu"):
        np.testing.assert_allclose(
            np32(t_layers.dense_mlp(ttree(mlp), torch.from_numpy(h), act)),
            np32(j_layers.dense_mlp(jtree(mlp), jnp.asarray(h), act)), **TOL)


def test_embedding_scale_and_padded_vocab_head():
    """The reference scales every embedding by sqrt(d_model) (qwen3
    included), and the head returns logits over the padded vocabulary:
    both kept on purpose."""
    jc = dataclasses.replace(j_configs.get("qwen3-4b").reduced(),
                             vocab_size=500)
    tc = dataclasses.replace(t_configs.get("qwen3-4b").reduced(),
                             vocab_size=500)
    assert tc.padded_vocab() == 512
    tree = t_w.seeded_numpy_params(tc, 3)
    tokens = np.asarray([[1, 499, 7]], np.int32)
    x = t_layers.embed_tokens(torch.from_numpy(tree["embed"]),
                              torch.from_numpy(tokens), tc)
    np.testing.assert_array_equal(
        np32(x), tree["embed"][tokens] * np.float32(np.sqrt(64.0)))
    np.testing.assert_array_equal(
        np32(x), np32(j_layers.embed_tokens(jtree(tree), jnp.asarray(tokens),
                                            jc)))
    logits = t_layers.logits_head(torch.from_numpy(tree["embed"]), None,
                                  x, tc)
    assert logits.shape == (1, 3, 512) and logits.dtype == torch.float32
    np.testing.assert_allclose(
        np32(logits), np32(j_layers.logits_head(jtree(tree), jnp.asarray(
            np32(x)), jc)), **TOL)
    tail = torch.zeros((2, 512))
    tail[:, 505] = 1.0                      # a padded id wins the argmax
    assert t_sampler.greedy(tail).tolist() == [505, 505]


def test_untied_head_with_final_softcap():
    jc = dataclasses.replace(j_configs.get("qwen3-4b").reduced(),
                             tie_embeddings=False, final_softcap=3.0)
    tc = dataclasses.replace(t_configs.get("qwen3-4b").reduced(),
                             tie_embeddings=False, final_softcap=3.0)
    tree = t_w.seeded_numpy_params(tc, 4)
    x = np.random.default_rng(4).standard_normal((2, 3, 64), np.float32)
    np.testing.assert_allclose(
        np32(t_layers.logits_head(torch.from_numpy(tree["embed"]),
                                  torch.from_numpy(tree["unembed"]),
                                  torch.from_numpy(x), tc)),
        np32(j_layers.logits_head(jtree(tree), jnp.asarray(x), jc)), **TOL)


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_attention_layers_and_caches_match_reference(name):
    """Each layer's mixer alone: attention (GQA or MLA) or Mamba2, its full
    forward, its prefill into a cache and 4 decode steps."""
    jc, tc = pair(name)
    tree = t_w.seeded_numpy_params(tc, 1)
    r = np.random.default_rng(1)
    b, s, max_len = 2, 12, 20
    x = r.standard_normal((b, s, tc.d_model), np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    for li, (jspec, tspec) in enumerate(zip(t_w.layer_specs(jc),
                                            t_w.layer_specs(tc))):
        p = layer_tree(tree, tc, li)["mixer"]
        jp, tp = jtree(p), ttree(p)
        if tspec.mixer == "mamba":
            np.testing.assert_allclose(
                np32(t_mamba.mamba_block(tp, torch.from_numpy(x), tc)),
                np32(j_mamba.mamba_block(jp, jnp.asarray(x), jc)), **TOL)
            jcache = j_mamba.init_mamba_cache(jc, b, jnp.float32)
            tcache = t_mamba.init_mamba_cache(tc, b, torch.float32, "cpu")
            jy, jcache = j_tf._mamba_prefill(jp, jnp.asarray(x), jcache, jc)
            ty, tcache = t_mamba.mamba_prefill(tp, torch.from_numpy(x),
                                               tcache, tc)
            step = lambda jc_, tc_, xn, _: (  # noqa: E731
                j_mamba.mamba_decode_step(jp, jnp.asarray(xn), jc_, jc),
                t_mamba.mamba_decode_step(tp, torch.from_numpy(xn), tc_, tc))
        else:
            np.testing.assert_allclose(
                np32(t_attn.attention(tp, torch.from_numpy(x), tc, tspec,
                                      torch.from_numpy(pos))),
                np32(j_attn.attention(jp, jnp.asarray(x), jc, jspec,
                                      jnp.asarray(pos))), **TOL)
            jcache = j_attn.init_kv_cache(jc, jspec, b, max_len, jnp.float32)
            tcache = t_attn.init_kv_cache(tc, tspec, b, max_len,
                                          torch.float32, "cpu")
            assert tcache["pos"].shape == jcache["pos"].shape  # shared
            jy, jcache = j_attn.prefill_into_cache(jp, jnp.asarray(x),
                                                   jcache, jc, jspec)
            ty, tcache = t_attn.prefill_into_cache(tp, torch.from_numpy(x),
                                                   tcache, tc, tspec)
            step = lambda jc_, tc_, xn, cur: (  # noqa: E731
                j_attn.decode_attention(jp, jnp.asarray(xn), jc_,
                                        jnp.int32(cur), jc, jspec),
                t_attn.decode_attention(tp, torch.from_numpy(xn), tc_, cur,
                                        tc, tspec))
        np.testing.assert_allclose(np32(ty), np32(jy), **TOL)
        assert_caches_equal([jcache], [tcache])
        for t in range(4):
            xn = r.standard_normal((b, 1, tc.d_model), np.float32)
            (jy, jcache), (ty, tcache) = step(jcache, tcache, xn, s + t)
            np.testing.assert_allclose(np32(ty), np32(jy), **TOL,
                                       err_msg=f"layer {li} step {t}")
            assert_caches_equal([jcache], [tcache])


# --------------------------------------------------------------------- LM

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lm_prefill_and_decode_match_reference(name):
    jc, tc = pair(name)
    tree = t_w.seeded_numpy_params(tc, 2)
    jm, tm = j_tf.LM(jc), LM(tc, device="cpu")
    t_w.params_from_numpy(tm, tree)
    jp = jtree(tree)
    r = np.random.default_rng(2)
    b, s, steps, max_len = 2, 12, 6, 24
    tokens = r.integers(0, tc.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": tokens, **extra_inputs(tc, b, s, r)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    np.testing.assert_allclose(np32(tm(tbatch)),
                               np32(jm.forward(jp, jbatch)), **TOL)

    jbatch.pop("positions", None)       # prefill reads none (as the
    tbatch.pop("positions", None)       # reference's prefill does not)
    jl, jcache = jax.jit(jm.prefill)(jp, jbatch, jm.init_caches(b, max_len))
    tl, tcache = tm.prefill(tbatch, tm.init_caches(b, max_len))
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_caches_equal(ref_layer_caches(jcache, jc), tcache)
    if tc.is_encdec:
        np.testing.assert_allclose(np32(tcache.enc_out),
                                   np32(jcache["enc_out"]), **TOL)
    jdecode = jax.jit(jm.decode_step)
    jcur = jnp.argmax(jl, -1).astype(jnp.int32)
    tcur = t_sampler.greedy(tl)
    for t in range(steps):
        assert tcur.tolist() == np.asarray(jcur).tolist(), f"step {t}"
        jl, jcache = jdecode(jp, jcur, jcache, jnp.int32(s + t))
        tl, tcache = tm.decode_step(tcur, tcache, s + t)
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL,
                                   err_msg=f"step {t}")
        assert_caches_equal(ref_layer_caches(jcache, jc), tcache)
        jcur = jnp.argmax(jl, -1).astype(jnp.int32)
        tcur = t_sampler.greedy(tl)


def test_lm_uses_the_reference_weight_layout_and_round_trips():
    tc = t_configs.get("qwen3-4b").reduced()
    tree = t_w.seeded_numpy_params(tc, 5)
    tm = build_model(tc, device="cpu")
    t_w.params_from_numpy(tm, tree)
    # (in, out) layout, x @ W: no transpose on the way in
    wq = tree["blocks"]["l0"]["mixer"]["wq"][0]
    assert tm.layers[0].mixer["wq"].shape == wq.shape == (64, 4 * 16)
    np.testing.assert_array_equal(tm.layers[0].mixer["wq"].numpy(), wq)
    back = t_w.params_to_numpy(tm)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, a in flat:
        np.testing.assert_array_equal(flat_back[path], a, err_msg=str(path))
    # the seeded tree has the reference's own structure and shapes
    ref = j_tf.LM(j_configs.get("qwen3-4b").reduced()).init(
        jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(jtree(tree))
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape


def test_init_weights_draws_the_reference_distributions():
    tc = t_configs.get("qwen3-4b").reduced()
    tm = LM(tc, device="cpu").init_weights(torch.Generator().manual_seed(0))
    d, f = tc.d_model, tc.d_ff
    assert float(tm.layers[0].ln1.min()) == float(tm.layers[0].ln1.max()) == 1
    assert abs(float(tm.embed.std()) - 0.02) < 0.002
    assert abs(float(tm.layers[0].mixer["wq"].std()) - d ** -0.5) < 0.01
    assert abs(float(tm.layers[0].mlp["w_down"].std()) - f ** -0.5) < 0.01
    again = LM(tc, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[0].mlp["w_up"], tm.layers[0].mlp["w_up"])


def test_lm_builds_every_architecture_and_computes_its_loss():
    """Every architecture's reduced config builds, and ``loss`` gives a
    finite f32 scalar (the parity of its value and gradients with the
    reference is tests/test_torch_train.py's)."""
    for arch in t_configs.ALL_ARCHS:
        cfg = t_configs.get(arch).reduced()
        tm = LM(cfg, device="cpu")
        assert len(tm.layers) == tm.cfg.num_layers
        assert len(tm.encoder_layers) == tm.cfg.encoder_layers
        t_w.params_from_numpy(tm, t_w.seeded_numpy_params(cfg, 0))
        r = np.random.default_rng(0)
        toks = r.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 **extra_inputs(cfg, 2, 8, r)}
        loss = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        assert loss.dtype == torch.float32 and loss.dim() == 0, arch
        assert bool(torch.isfinite(loss)), arch


def test_lm_without_a_card_needs_device_cpu():
    from repro_torch.core.engine import BackendError
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(BackendError, match="device='cpu'"):
        LM(t_configs.get("qwen3-4b").reduced())
