"""The port's one-device dry run (``repro_torch.launch.specs``,
``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.specs``, ``repro.launch.dryrun``), on the CPU.

The specs: every cell's inputs, parameters and caches on ``meta`` have
the reference's shapes and dtypes (the reference's through
``jax.eval_shape``; the port's parameters through ``models.weights``'
reference-shaped tree).  The report: ``lower_cell`` counts a cell at
full width on ``meta`` and returns the reference's keys; on the
production meshes (a fake process group of 256 or 512 ranks in a fresh
process) it counts per chip, with the reference's keys, its ``mesh`` and
``chips``, and the CLI writes ``__pod1`` / ``__pod2`` files; the
attention wrappers on ``meta`` launch nothing and run no plain
version."""
import json

import jax
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.checkpoint import checkpointer as j_ckpt  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.roofline import model_flops as j_model_flops  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.engine import BackendError  # noqa: E402
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import weights as W  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = list(t_configs.ALL_ARCHS)
CELLS = [(a, s) for a, s, _ in t_configs.cells(include_skipped=True)]

# The reference's report keys (src/repro/launch/dryrun.py, lower_cell's
# ``report`` and ``roofline_terms``)
REF_KEYS = {
    "arch", "shape", "mesh", "chips", "kind", "microbatches", "ok",
    "lower_s", "compile_s", "hlo_flops_per_chip", "hlo_bytes_per_chip",
    "collective_bytes_per_chip", "collective_by_kind", "collective_counts",
    "xla_cost_analysis_flops", "model_flops_per_chip", "useful_flops_ratio",
    "memory", "bytes_per_chip", "t_compute_s", "t_memory_s",
    "t_collective_s", "dominant", "bound_s", "roofline_fraction"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}


def sd(x):
    """(shape, dtype name) of a jax or torch array or a port ``Leaf``."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_are_the_references(arch, shape):
    want = j_specs.input_specs(j_configs.get(arch), j_configs.SHAPES[shape])
    got = S.input_specs(t_configs.get(arch), t_configs.SHAPES[shape])
    assert {k: sd(v) for k, v in got.items()} == \
        {k: sd(v) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_are_the_references(arch):
    want = j_specs.abstract_params(j_build(j_configs.get(arch)))
    names, leaves, _ = j_ckpt._leaf_paths(want)
    model = LM(t_configs.get(arch), device=S.META)
    got = {n: sd(x) for n, x in flatten(S.abstract_params(model))}
    assert got == {n: sd(x) for n, x in zip(names, leaves)}
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_caches_are_the_references(arch):
    """Each layer's cache leaves against the reference's (its blocks
    stacked over the repeats), and ``enc_out`` of an encoder-decoder, at
    the decode and prefill shapes."""
    jcfg, tcfg = j_configs.get(arch), t_configs.get(arch)
    model = LM(tcfg, device=S.META)
    for shape in ("prefill_32k", "decode_32k"):
        want = j_specs.abstract_caches(j_build(jcfg),
                                       j_configs.SHAPES[shape])
        got = S.abstract_caches(model, t_configs.SHAPES[shape])
        assert len(got) == len(model.layers)
        for li, cache in enumerate(got):
            where, i = W.layer_source(tcfg, li)
            ref = (want["prefix"][i] if where == "prefix" else
                   jax.tree_util.tree_map(   # one block of the stacked ones
                       lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                       want["blocks"][where]))
            assert {k: sd(v) for k, v in cache.items()} == \
                {k: sd(v) for k, v in ref.items()}, (shape, li)
        if tcfg.is_encdec:
            assert sd(got.enc_out) == sd(want["enc_out"])
        else:
            assert got.enc_out is None and "enc_out" not in want


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-4b", "prefill_32k"), ("qwen3-4b", "decode_32k"),
    ("mamba2-780m", "long_500k"), ("deepseek-moe-16b", "decode_32k"),
    ("seamless-m4t-medium", "decode_32k")])
def test_lower_cell_reports_the_references_keys(arch, shape):
    rep = D.lower_cell(arch, shape)
    assert REF_KEYS <= set(rep) and set(rep["memory"]) == MEMORY_KEYS
    assert rep["device"] == "meta" and rep["chips"] == 1
    assert rep["mesh"] == "1" and rep["ok"]
    assert rep["model_flops_per_chip"] == j_model_flops(
        j_configs.get(arch), j_configs.SHAPES[shape])
    assert rep["hlo_flops_per_chip"] >= rep["model_flops_per_chip"] > 0
    assert rep["hlo_bytes_per_chip"] > 0 and rep["bound_s"] > 0
    assert rep["collective_bytes_per_chip"] == 0
    assert rep["fits"] == (rep["bytes_per_chip"] <= rep["hbm_bytes"])
    assert ("balanced" in rep["counted_on"]) == (arch == "deepseek-moe-16b")
    assert rep["dominant"] == ("compute" if shape == "prefill_32k"
                               else "memory")


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-medium"])
def test_decode_cell_counts_its_weights_and_caches(arch):
    """A decode cell's arguments are its weights, its token and its
    caches, ``enc_out`` included; qwen3-4b's KV cache at decode_32k is
    128 x 32 768 x 36 layers x 8 heads x 128 x 4 B x 2 (K and V), so the
    cell does not fit on one card."""
    cfg, shape = t_configs.get(arch), t_configs.SHAPES["decode_32k"]
    model = LM(cfg, device=S.META)
    caches = S.abstract_caches(model, shape)
    nbytes = [t.numel() * t.element_size() for t in
              [*model.parameters(), *(x for c in caches for x in c.values()),
               *([caches.enc_out] if cfg.is_encdec else [])]]
    rep = D.lower_cell(arch, "decode_32k")
    args = rep["memory"]["argument_size_in_bytes"]
    assert args == sum(nbytes) + shape.global_batch * 4     # int32 tokens
    assert rep["bytes_per_chip"] >= args
    if arch == "qwen3-4b":
        kv = 128 * 32768 * 36 * 8 * 128 * 4 * 2
        assert sum(nbytes) - sum(p.numel() * p.element_size()
                                 for p in model.parameters()) >= kv
        assert not rep["fits"]


def test_dryrun_main_writes_the_cells_of_an_arch(tmp_path):
    D.main(["--arch", "qwen3-4b", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == sorted(f"qwen3-4b__{s}__{D.MESH_TAG}.json"
                           for s in t_configs.SHAPES)
    for p in tmp_path.glob("*.json"):
        rep = json.loads(p.read_text())
        if rep["shape"] == "long_500k":      # full attention: the
            assert rep["skipped"]            # reference's documented skip
            continue
        assert rep["ok"] and REF_KEYS <= set(rep), rep.get("error")


def test_production_meshes_raise_naming_a84(tmp_path):
    """The production meshes, once refused naming ROADMAP A8.4, now count:
    ``lower_cell(multi_pod=True)`` per chip of (2, 16, 16), and
    ``--both-meshes`` writes a report of a cell on each mesh."""
    rep = D.lower_cell("h2o-danube-1.8b", "decode_32k", multi_pod=True)
    assert REF_KEYS <= set(rep) and rep["ok"]
    assert (rep["mesh"], rep["chips"]) == ("2x16x16", 512)
    D.main(["--both-meshes", "--arch", "h2o-danube-1.8b", "--shape",
            "decode_32k", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == [f"h2o-danube-1.8b__decode_32k__{t}.json"
                     for t in ("pod1", "pod2")]
    for p, (mesh, chips) in zip(sorted(tmp_path.glob("*.json")),
                                (("16x16", 256), ("2x16x16", 512))):
        r = json.loads(p.read_text())
        assert r["ok"] and (r["mesh"], r["chips"]) == (mesh, chips)


@pytest.mark.parametrize("multi_pod,mesh,chips", [(False, "16x16", 256),
                                                  (True, "2x16x16", 512)])
def test_a_full_width_production_cell_counts_per_chip(multi_pod, mesh,
                                                      chips):
    """qwen3-4b x decode_32k on a production mesh: the reference's keys,
    per-chip FLOPs and argument bytes below the one-chip count's, a
    sequence-sharded KV cache (8 KV heads on 16) decoded with one
    all-gather of (output, log-sum-exp) a layer, and the weights and the
    rank's cache in ``bytes_per_chip``."""
    rep = D.lower_cell("qwen3-4b", "decode_32k", multi_pod=multi_pod)
    one = D.lower_cell("qwen3-4b", "decode_32k")
    assert REF_KEYS <= set(rep) and rep["ok"]
    assert (rep["mesh"], rep["chips"]) == (mesh, chips)
    assert rep["hlo_flops_per_chip"] < one["hlo_flops_per_chip"] / 16
    assert rep["memory"]["argument_size_in_bytes"] < \
        one["memory"]["argument_size_in_bytes"] / 16
    assert rep["collective_counts"]["all-gather"] >= 2 * 36
    assert rep["model_flops_per_chip"] == one["model_flops_per_chip"] / chips
    assert rep["fits"] == (rep["bytes_per_chip"] <= rep["hbm_bytes"])


def test_meta_is_for_the_model_alone():
    """``LM`` takes ``meta``; the simulator's and pool's entry points
    still raise on it."""
    from repro_torch.runtime import simulate_online
    from repro_torch.serving import MorpheusPagePool, PoolConfig
    with pytest.raises(BackendError):
        simulate_online("cfd", "Morpheus-ALL", length=1000, device="meta")
    with pytest.raises(BackendError):
        MorpheusPagePool(PoolConfig(), device="meta")


def test_wrappers_on_meta_launch_nothing():
    """The attention wrappers on ``meta``: empty outputs of the kernels'
    shapes and dtypes, no launch, no plain run; the decode needs its
    valid count there."""
    meta = torch.device("meta")
    q = torch.empty((2, 8, 4, 64), dtype=torch.bfloat16, device=meta)
    k = torch.empty((2, 12, 2, 64), dtype=torch.bfloat16, device=meta)
    v = torch.empty((2, 12, 2, 32), dtype=torch.bfloat16, device=meta)
    att.reset_launches()
    out = att.flash_attention(q, k, v, causal=False)
    assert out.shape == (2, 8, 4, 32) and out.dtype == torch.bfloat16
    out, lse = att.flash_attention_with_lse(q, k, v, causal=False)
    assert lse.shape == (2, 8, 4) and lse.dtype == torch.float32
    grads = att.flash_attention_backward(q, k, v, out, out, lse,
                                         causal=False)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert all(g.is_contiguous() for g in grads)
    qd = torch.empty((2, 4, 64), device=meta)
    kd = torch.empty((2, 12, 2, 64), device=meta)
    valid = torch.empty((2, 12), dtype=torch.bool, device=meta)
    out = att.decode_attention(qd, kd, kd, valid, valid_count=20)
    assert out.shape == (2, 4, 64) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="valid_count"):
        att.decode_attention(qd, kd, kd, valid)
    assert set(att.launches.values()) == {0}
    assert set(att.plain_runs.values()) == {0}
