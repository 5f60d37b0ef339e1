"""Tensor and context parallelism over DTensor
(``repro_torch.distributed.tensor_parallel``) on ``gloo`` worlds of
spawned CPU ranks, against the reference's unsharded model, and the
per-chip count on ``fake`` groups against the reference's GSPMD
lowering.

Three worlds, each started once for the module, all at once: 4 ranks
(meshes (1, 4) and (2, 2)), 2 ranks ((1, 2)) and 3 ranks ((1, 3): the
context-parallel path, 4 query heads on a model axis of 3).  Every
family's reduced config runs on every mesh of the worlds of 4 and 2:
its weights placed from ``seeded_numpy_params`` (each rank keeping its
shards, which must equal ``sharding.local_params``), the forward, a
prefill and ``NEW`` greedy decode steps; on one mesh each, the loss and
its gradients.  The rank bodies live in ``tests/torch_tp_ranks.py``,
which imports no JAX.

Bounds: logits (the forward's and every decode step's) within 1e-4 of
the reference's (rtol = atol, the families' bound,
``tests/test_torch_models.py``), greedy tokens identical; the loss
within 2.3e-7 relative of the port's one-process loss (the bound of
that loss against the reference) and so within twice it of the
reference's (the shards' partial sums add in another order: gemma3's is
3 f32 ulps off the reference's); each gradient leaf, gathered whole,
within 3.5e-5 of its largest entry (at least 1) of the reference's
gradient on the same weights and batch.  The kernels' options: plain
versions exact to 1e-6 against the whole call."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.checkpoint import checkpointer as j_ckpt  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.distributed import world  # noqa: E402
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402
from repro_torch.pytree import flatten as t_flatten  # noqa: E402
from repro_torch.train import loop as t_loop  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from test_torch_train import assert_params_close  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = list(t_configs.ALL_ARCHS)
B, S, NEW, MAX_LEN = 2, 12, 4, 24     # the cache divides 2, 3 and 4
MESHES = {4: [(1, 4), (2, 2)], 2: [(1, 2)]}
GRAD_MESH = {a: [(1, 4), (2, 2), (1, 2)][i % 3] for i, a in enumerate(ARCHS)}
CP = ("qwen2-vl-7b", (1, 3))          # 4 query heads on a model axis of 3
# 8 experts on a model axis of 3: the reference's dense layer, replicated
MOE_TP = ("deepseek-moe-16b", (1, 3))
MOE_TOKENS, MOE_TOL = 48, dict(rtol=1e-5, atol=1e-5)
CKPT = dict(arch="qwen3-4b", steps=3, batch=4, seq=16)
CKPT_MESH = (2, 2)                    # moments ZeRO-1 sharded over data
LR = 3e-4                             # train()'s default
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL, GRAD_TOL = 2.3e-7, 3.5e-5
ROOT = Path(__file__).resolve().parents[1]


def batch_of(cfg, r, b=B, s=S):
    """Tokens and the optional inputs a family reads
    (``test_torch_models.extra_inputs``)."""
    out = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encdec:
        out["frame_embeds"] = r.standard_normal((b, 5, cfg.d_model),
                                                np.float32)
    if cfg.mrope_sections is not None:
        out["patch_embeds"] = 0.1 * r.standard_normal((b, 3, cfg.d_model),
                                                      np.float32)
        t = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        out["positions"] = np.stack([t, t // 2, t % 3 + 5])
    return out


def case_of(arch: str, meshes, grad_mesh=None) -> dict:
    cfg = t_configs.get(arch).reduced()
    r = np.random.default_rng(7)
    batch = batch_of(cfg, r)
    toks = r.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    train = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             **{k: v for k, v in batch.items() if k != "tokens"}}
    return {"name": arch, "arch": arch, "meshes": list(meshes),
            "tree": seeded_numpy_params(cfg, 3), "batch": batch,
            "train": train, "new": NEW, "max_len": MAX_LEN,
            "grad_mesh": grad_mesh}


def world_cases(n: int) -> list:
    return [case_of(a, MESHES[n], GRAD_MESH[a]) for a in ARCHS]


def ckpt_case() -> dict:
    cfg = t_configs.get(CKPT["arch"]).reduced()
    return dict(CKPT, tree=seeded_numpy_params(cfg, 3))


@pytest.fixture(scope="module")
def tp_ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ckpt")


@pytest.fixture(scope="module")
def worlds(tp_ckpt_dir):
    """The three worlds on threads of their own (each waits on its ranks),
    while the reference's values are computed here; the world of 4 also
    trains with checkpoints (``R.train_resumed``)."""
    cp = case_of(CP[0], [CP[1]], CP[1])
    ckpt = {4: (ckpt_case(), CKPT_MESH, str(tp_ckpt_dir))}
    with ThreadPoolExecutor(3) as pool:
        yield {n: pool.submit(world.spawn, R.world_families, n, cases,
                              ckpt.get(n), device="cpu", timeout_s=600)
               for n, cases in ((4, world_cases(4)), (2, world_cases(2)),
                                (3, [cp, moe_tp_case()]))}


def moe_tp_case() -> dict:
    """``MOE_TP``'s family case, with ``MOE_TOKENS`` rows for its first
    MoE layer alone."""
    case = case_of(MOE_TP[0], [MOE_TP[1]], MOE_TP[1])
    cfg = t_configs.get(MOE_TP[0]).reduced()
    case["moe_x"] = np.random.default_rng(11).standard_normal(
        (MOE_TOKENS, cfg.d_model)).astype(np.float32)
    return case


def result(worlds, arch: str, mesh) -> dict:
    n = int(np.prod(mesh))
    return worlds[n].result()[0]["results"][(arch, tuple(mesh))]


@pytest.fixture(scope="module")
def refs():
    """The reference's forward, prefill, greedy decode, loss and gradients
    of every family on the cases' weights and inputs."""
    out = {}
    for arch in ARCHS:
        case = case_of(arch, [])
        jcfg = j_configs.get(arch).reduced()
        jm = j_tf.LM(jcfg)
        jp = jax.tree_util.tree_map(jnp.asarray, case["tree"])
        jb = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        fwd = np.asarray(jm.forward(jp, jb), np.float32)
        jb.pop("positions", None)
        logits, caches = jax.jit(jm.prefill)(jp, jb, jm.init_caches(
            B, MAX_LEN))
        toks, steps = [jnp.argmax(logits, -1)], [np.asarray(logits)]
        decode = jax.jit(jm.decode_step)
        for i in range(NEW):
            logits, caches = decode(jp, toks[-1].astype(jnp.int32), caches,
                                    jnp.int32(S + i))
            toks.append(jnp.argmax(logits, -1))
            steps.append(np.asarray(logits))
        loss, grads = jax.value_and_grad(jm.loss)(
            jp, {k: jnp.asarray(v) for k, v in case["train"].items()})
        model = LM(t_configs.get(arch).reduced(), device="cpu")
        params_from_numpy(model, case["tree"])
        with torch.no_grad():
            one = model.loss({k: torch.from_numpy(v)
                              for k, v in case["train"].items()})
        out[arch] = {"forward": fwd,
                     "tokens": np.stack([np.asarray(t) for t in toks]),
                     "step_logits": np.stack(steps), "loss": float(loss),
                     "grads": ref_paths(grads), "one_loss": float(one)}
    return out


def loss_close(got: float, want: dict) -> None:
    """Within ``LOSS_RTOL`` of the one-process port's loss, which
    ``test_torch_train`` holds within it of the reference's, and so within
    twice it of the reference's."""
    one, ref = want["one_loss"], want["loss"]
    assert abs(got - one) <= LOSS_RTOL * abs(one), (got, one)
    assert abs(got - ref) <= 2 * LOSS_RTOL * abs(ref), (got, ref)


def ref_paths(tree) -> dict:
    """The reference's {leaf path: numpy array}, paths as its checkpointer
    (and the port's ``pytree.flatten``) name them."""
    names, leaves, _ = j_ckpt._leaf_paths(tree)
    return {n: np.asarray(x) for n, x in zip(names, leaves)}


def grad_close(got: dict, want: dict, ctx: str) -> None:
    assert sorted(got) == sorted(want), ctx
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, f"{ctx} {k}"
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, f"{ctx} {k}: {err} ({scale})"


MESH_CASES = [(a, m) for a in ARCHS for n in (4, 2) for m in MESHES[n]]


@pytest.mark.parametrize("arch,mesh", MESH_CASES)
def test_forward_matches_the_reference(worlds, refs, arch, mesh):
    got = result(worlds, arch, mesh)
    np.testing.assert_allclose(got["forward"], refs[arch]["forward"], **TOL)


@pytest.mark.parametrize("arch,mesh", MESH_CASES)
def test_prefill_and_greedy_decode_match_the_reference(worlds, refs, arch,
                                                       mesh):
    got, want = result(worlds, arch, mesh), refs[arch]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["step_logits"], want["step_logits"],
                               **TOL)
    assert got["plain_runs"]["flash_attention_q_start"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_one_process(worlds, refs, arch):
    """The loss against the one-process port and the reference, each
    gradient leaf (gathered whole) against the reference's on the same
    weights and batch."""
    got = result(worlds, arch, GRAD_MESH[arch])
    loss_close(got["loss"], refs[arch])
    grad_close(got["grads"], refs[arch]["grads"],
               f"{arch} on {GRAD_MESH[arch]}")


def test_each_ranks_shards_are_its_local_params(worlds):
    for n in (4, 2, 3):
        ranks = worlds[n].result()
        assert [r["rank"] for r in ranks] == list(range(n))
        assert all(r["shards_ok"] for r in ranks), n


def test_context_parallel_prefill_decode_and_gradients(worlds, refs):
    """qwen2-vl's 4 query heads on a model axis of 3: q sharded by
    sequence, each rank's flash call (forward and backward) at its
    ``q_start``, the KV cache sequence-sharded (2 KV heads) and merged by
    log-sum-exp; against the reference and the one-process port."""
    arch, mesh = CP
    got, want = result(worlds, arch, mesh), refs[arch]
    np.testing.assert_allclose(got["forward"], want["forward"], **TOL)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["step_logits"], want["step_logits"],
                               **TOL)
    loss_close(got["loss"], want)
    grad_close(got["grads"], want["grads"], "context parallel")
    runs = [r["plain"][(arch, mesh)] for r in worlds[3].result()]
    assert runs[0]["flash_attention_q_start"] == 0      # rank 0: q_start 0
    for r in runs[1:]:
        assert r["flash_attention_q_start"] > 0
        assert r["flash_attention_backward_q_start"] > 0
    assert all(r["decode_attention_with_lse"] > 0 for r in runs)


def test_moe_on_a_model_axis_that_does_not_divide_its_experts(worlds,
                                                              refs):
    """Reduced deepseek-moe-16b (8 experts) on (1, 3): the MoE layers run
    the one-process layer on experts replicated over ``model`` (the
    reference's ``_moe_mlp_dense``), its 4 query heads context-parallel;
    forward, tokens, loss and gradients against the reference."""
    arch, mesh = MOE_TP
    got, want = result(worlds, arch, mesh), refs[arch]
    np.testing.assert_allclose(got["forward"], want["forward"], **TOL)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["step_logits"], want["step_logits"],
                               **TOL)
    loss_close(got["loss"], want)
    grad_close(got["grads"], want["grads"], f"{arch} on {mesh}")


def test_moe_layer_on_a_model_axis_of_3_is_the_references_dense_layer(
        worlds, tmp_path):
    """The MoE layer alone on (1, 3) against the reference's ``moe_mlp``
    under its (1, 3) mesh of 3 host devices, on the same weights and
    rows: within 1e-5."""
    arch, mesh = MOE_TP
    case = moe_tp_case()
    layer = {n.split("/mlp/", 1)[1]: v[0] for n, v in t_flatten(case["tree"])
             if n.startswith("blocks/l0/mlp/")}
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, x=case["moe_x"], **{f"p/{k}": v for k, v in layer.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=3")
    subprocess.run([sys.executable, str(ROOT / "tests" / "torch_gspmd_ref.py"),
                    "moe", str(src), str(dst), arch], env=env, timeout=300,
                   check=True, capture_output=True)
    got = result(worlds, arch, mesh)["moe_y"]
    np.testing.assert_allclose(got, np.load(dst)["y"], **MOE_TOL)


def test_moe_fallback_counts_the_one_device_layer_on_every_chip():
    """On a fake group of 3, ``count_cell`` counts reduced
    deepseek-moe-16b's prefill on (1, 3), and its MoE layer costs every
    chip the one-device layer's FLOPs (the experts replicated)."""
    got = D.in_fake_world(3, R.moe_fallback_counts, MOE_TP[0], MOE_TOKENS, 3)
    assert got["cell"] > 0
    assert got["layer"] == got["layer_one"] > 0


def test_sequence_sharded_cache_decodes_through_the_lse_merge(worlds):
    """qwen3's 2 KV heads on a model axis of 4: the cache is
    sequence-sharded, each rank decodes its block with
    ``decode_attention_with_lse``; on (1, 2) they divide: head shards."""
    four = [r["plain"][("qwen3-4b", (1, 4))] for r in worlds[4].result()]
    two = [r["plain"][("qwen3-4b", (1, 2))] for r in worlds[2].result()]
    assert all(r["decode_attention_with_lse"] > 0 and
               r["decode_attention"] == 0 for r in four)
    assert all(r["decode_attention"] > 0 and
               r["decode_attention_with_lse"] == 0 for r in two)


def ckpt_leaves(path: Path) -> dict:
    """{leaf path: array} of one checkpoint directory."""
    manifest = json.loads((path / "manifest.json").read_text())
    return {e["path"]: np.load(path / f"leaf_{e['index']}.npy")
            for e in manifest["leaves"]}


def test_tensor_parallel_training_checkpoints_and_resumes(worlds, tp_ckpt_dir,
                                                         tmp_path):
    """``train`` on (2, 2) with a checkpoint every step, stopped after one
    step and resumed to three: the losses, the parameters and the last
    checkpoint (the one-device layout: parameters and AdamW moments
    gathered whole, the moments from their ZeRO-1 shards) are those of
    the port's one-process run that stops and resumes alike."""
    case = ckpt_case()
    got = worlds[4].result()[0]["ckpt"]
    kw = dict(batch=CKPT["batch"], seq=CKPT["seq"], seed=0, device="cpu",
              init=case["tree"], ckpt_every=1, ckpt_dir=str(tmp_path),
              print_fn=lambda *_: None)
    cfg = t_configs.get(CKPT["arch"]).reduced()
    _, first, _ = t_loop.train(cfg, steps=1, **kw)
    state, losses, rep = t_loop.train(cfg, steps=CKPT["steps"], **kw)
    assert got["resumed_from"] == rep.resumed_from == 1
    assert got["steps_run"] == rep.steps_run == CKPT["steps"] - 1
    want = first + losses
    assert len(got["losses"]) == len(want) == CKPT["steps"]
    for a, b in zip(got["losses"], want):
        assert abs(a - b) <= 1e-5 * abs(b), (got["losses"], want)
    params = {n: leaf.numpy() for n, leaf in t_flatten(state.params)}
    assert got["params"].keys() == params.keys()
    for k, w in params.items():
        assert_params_close(got["params"][k], w, LR, CKPT["steps"], k)
    last = f"step_{CKPT['steps']:08d}"
    mine, one = (ckpt_leaves(Path(d) / last) for d in (tp_ckpt_dir, tmp_path))
    assert mine.keys() == one.keys()
    for k, w in one.items():
        assert mine[k].shape == w.shape and mine[k].dtype == w.dtype, k
        if w.ndim == 0:
            assert mine[k] == w, k
        else:
            assert_params_close(mine[k], w, LR, CKPT["steps"], k)


def test_a_model_axis_trains_only_tensor_parallel():
    """One training path on a model axis: the train step refuses a mesh
    whose model axis is more than one rank for a model that
    ``distribute_model`` did not place."""
    assert "tensor-parallel" in D.in_fake_world(4, R.replicated_step_refused)


def test_the_worlds_ranks_imported_no_jax(worlds):
    for n in (4, 2, 3):
        assert all(not r["jax"] for r in worlds[n].result())


# ------------------------------------------------ the kernels' options

Q_START_CASES = [dict(causal=True), dict(causal=True, window=3),
                 dict(causal=True, softcap=5.0),
                 dict(causal=False)]


@pytest.mark.parametrize("kw", Q_START_CASES)
def test_flash_q_start_rows_equal_the_whole_call(kw):
    """Rows [a, b) with ``q_start = a`` equal rows [a, b) of the whole
    call: the output, dQ of the block, and dK/dV summed over the blocks."""
    r = np.random.default_rng(11)
    q, do = (torch.from_numpy(r.standard_normal((2, 12, 4, 16), np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(r.standard_normal((2, 12, 2, 16), np.float32))
            for _ in range(2))
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    whole = att.flash_attention(qq, kk, vv, **kw)
    whole.backward(do)
    outs, dqs, dk, dv = [], [], 0, 0
    for a, b in ((0, 4), (4, 8), (8, 12)):
        qb = q[:, a:b].contiguous().requires_grad_()
        k2, v2 = k.clone().requires_grad_(), v.clone().requires_grad_()
        out = att.flash_attention(qb, k2, v2, q_start=a, **kw)
        out.backward(do[:, a:b].contiguous())
        outs.append(out.detach())
        dqs.append(qb.grad)
        dk, dv = dk + k2.grad, dv + v2.grad
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat(outs, 1), whole.detach(), **tol)
    torch.testing.assert_close(torch.cat(dqs, 1), qq.grad, **tol)
    torch.testing.assert_close(dk, kk.grad, **tol)
    torch.testing.assert_close(dv, vv.grad, **tol)
    if kw["causal"]:            # the offset is no no-op: rows from 4
        wrong = att.flash_attention(q[:, 4:8].contiguous(), k, v, **kw)
        assert not torch.allclose(wrong, whole.detach()[:, 4:8])


@pytest.mark.parametrize("cap", [0.0, 4.0])
def test_decode_with_lse_halves_merge_into_the_whole_call(cap):
    r = np.random.default_rng(12)
    q = torch.from_numpy(r.standard_normal((2, 4, 16), np.float32))
    k, v = (torch.from_numpy(r.standard_normal((2, 20, 2, 16), np.float32))
            for _ in range(2))
    valid = torch.from_numpy(r.random((2, 20)) < 0.7)
    valid[0, 10:] = False                  # a half with no valid key
    outs, lses = [], []
    for a, b in ((0, 10), (10, 20)):
        o, lse = att.decode_attention_with_lse(
            q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
            valid[:, a:b].contiguous(), softcap=cap)
        assert lse.shape == (2, 4) and lse.dtype == torch.float32
        outs.append(o)
        lses.append(lse)
    got = att.combine_decode(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(
        got, att.decode_attention(q, k, v, valid, softcap=cap),
        rtol=1e-6, atol=1e-6)
    assert not torch.allclose(outs[0], got)       # the merge is no no-op


# ------------------------------------------- the count, per chip

PARITY = [("qwen3-4b", "prefill", 4, 16, None),
          ("qwen3-4b", "train", 4, 16, None),
          ("deepseek-moe-16b", "prefill", 4, 16, None),
          ("deepseek-moe-16b", "train", 4, 16, None),
          ("qwen2-vl-7b", "prefill", 4, 512, (3, 1)),
          ("qwen2-vl-7b", "train", 4, 512, (3, 1))]
# the reference's per-chip FLOPs over the port's, on one footing, where
# they differ (ROADMAP §C 9): the reference's expert FFN runs on
# capacity buffers, the port's on the kept pairs (deepseek-moe); qwen3
# train: the MLP's weights are replicated (one block does not divide
# the model axis) and so are its rows, and GSPMD splits the backward's
# three weight-gradient products (x^T dgate, x^T dup, (a u)^T dy) over
# ``model`` by F and all-gathers them, 262 144 FLOPs a chip each, where
# every rank of the port computes each whole, 524 288: 786 432 more a
# chip, the whole difference
PINNED = {("qwen3-4b", "train"): 0.926829268,
          ("deepseek-moe-16b", "prefill"): 1.151898734,
          ("deepseek-moe-16b", "train"): 1.116022099}


def dense_footing(cost: dict, b, h, s, t, hd, hdv) -> float:
    """The port's FLOPs with the attention kernels' charges (the pairs
    the masks let through) swapped for the reference's dense dots over
    all S x T pairs of the rank's block, twice those in a backward
    (``test_torch_roofline.dense_footing``, per chip)."""
    dense = 2 * b * h * s * t * (hd + hdv)
    flops = cost["flops"]
    for name, per_call in (("flash_attention", dense),
                           ("flash_attention_backward", 2 * dense)):
        calls, charged, _ = cost["by_name"].get(name, (0, 0.0, 0.0))
        flops += calls * per_call - charged
    return flops


@pytest.fixture(scope="module")
def parity():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_gspmd_ref.py"),
         json.dumps(PARITY)], capture_output=True, text=True, env=env,
        timeout=600, check=True)
    port = D.in_fake_world(4, R.count_on_mesh, PARITY)
    return json.loads(ref.stdout.strip().splitlines()[-1]), port


@pytest.mark.parametrize("i", range(len(PARITY)))
def test_per_chip_flops_equal_the_references_gspmd_lowering(parity, i):
    """Each cell on a (2, 2) mesh: the reference's shardings lowered by
    GSPMD and counted by ``hlo_cost``, the port's DTensor step counted on
    a fake group of 4; equal within 1 % on one footing, or at the pinned
    ratio of ``PINNED``."""
    arch, kind, b, s, heads = PARITY[i]
    ref, port = parity[0][i], parity[1][i]
    cfg = R.config(arch, heads)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if heads and h % 2:     # context parallel: half the rows, every head
        got = dense_footing(port, b // 2, h, s // 2, s, hd, hd)
    else:
        got = dense_footing(port, b // 2, h // 2, s, s, hd, hd)
    ratio = ref["flops"] / got
    want = PINNED.get((arch, kind), 1.0)
    assert abs(ratio / want - 1) <= 0.01, (arch, kind, ratio)


def test_a_step_counts_the_same_twice_on_a_fake_group():
    """DTensor's sharding propagation runs each new op once on global
    shapes and caches it: the counter leaves those runs out, so the same
    cell counts the same the first and the second time."""
    first, second = D.in_fake_world(256, R.count_twice, "h2o-danube-1.8b",
                                    "decode_32k")
    assert first == second


def test_column_then_row_parallel_mlp_costs_a_quarter_and_one_all_reduce():
    """The MLP on (1, 4): a quarter of the one-device FLOPs, and one
    all-reduce of the (B, D) f32 output."""
    b, d, f = 8, 64, 256
    out = D.in_fake_world(4, R.mlp_cost, d, f, b)
    flops, by_kind, counts = out["sharded"]
    assert flops == out["whole"] / 4
    assert by_kind == {"all-reduce": b * d * 4}
    assert counts["all-reduce"] == 1
