"""The benchmark's three configurations name no layer layout and so are
GQA (``layouts/gqa.py``), and the layouts leave them exactly as the
harness had them before layouts existed: the leaves of a layer and of
the top, the bytes drawn for them at a tiny width, the program's
``ArchConfig``, the FLOP counts and the flash kernel's shape, each held
to the value ``recorded_layouts.json`` recorded from that harness.  A
layout that a file names and that has no module, or that would pass the
program a key that is not its config's, stops the run.  A configuration
of another layout, its cell and its limits are new files and new entries
alone: this suite passes on a copy of the benchmark that has them."""
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import layouts
from conftest import BENCH, TINY, TINY_MIX
from layouts import gqa
from pbcore import cell, program, readings
from pbcore import weights as W
from test_pb_mla import TINY_MLA
from work import flops

RECORDED = json.load(open(BENCH / "tests" / "recorded_layouts.json"))
CONFIGS = sorted(RECORDED)
DRAW_SEED = 2 ** 33 + 5


def conf(name: str) -> dict:
    return json.load(open(BENCH / "configs" / f"{name}.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_recorded_config_is_there_and_gqa(name):
    assert conf(name).get("layout", "gqa") == "gqa"


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves(name):
    cfg, rec = conf(name), RECORDED[name]
    assert layouts.of(cfg) is gqa
    for li, want in rec["leaves"].items():
        got = [[lf.name, list(lf.shape), lf.scale]
               for lf in W.layer_leaves(cfg, int(li))]
        assert got == want, li
    assert [[lf.name, list(lf.shape), lf.scale]
            for lf in W.top_leaves(cfg)] == rec["top"]


def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_drawn_bytes(name):
    cfg = conf(name)
    tiny, cpu = dict(cfg, **TINY[cfg["repo_config"]]), torch.device("cpu")
    want = RECORDED[name]["tiny_draws"]
    got = {str(li): _digest(W.draw_layer(tiny, DRAW_SEED, li, cpu))
           for li in range(tiny["num_layers"])}
    got["top"] = _digest(W.draw_top(tiny, DRAW_SEED, cpu))
    assert got == want


@pytest.mark.parametrize("name", CONFIGS)
def test_arch_config(name):
    arch = dataclasses.asdict(program.arch_of(conf(name)))
    assert json.loads(json.dumps(arch)) == RECORDED[name]["arch"]


@pytest.mark.parametrize("name", CONFIGS)
def test_flash_shape(name):
    cfg = conf(name)
    h, kv, hd = RECORDED[name]["attn"]
    assert readings._attn(cfg) == (h, kv, hd, hd)
    assert gqa.attn_shape(cfg) == (h, kv, hd, hd)


@pytest.mark.parametrize("name", CONFIGS)
def test_flop_counts(name):
    cfg, want = conf(name), RECORDED[name]["flops"]
    assert [flops.layer_matmul_params(cfg, li)
            for li in range(cfg["num_layers"])] == want["layer_matmul_params"]
    assert [flops.attention_flops(cfg, 8, 1024, 1024),
            flops.attention_flops(cfg, 8, 1, 1040, 1039)
            ] == want["attention_flops"]
    assert flops.prefill_flops(cfg, 16, 512) == want["prefill_flops"]
    assert flops.decode_flops(cfg, 8, 1030) == want["decode_flops"]
    assert flops.train_flops(cfg, 1, 4096) == want["train_flops"]


def test_unknown_layout_names_its_file():
    cfg = dict(conf("qwen2-vl-7b"), layout="ring")
    for fn in (lambda: W.layer_leaves(cfg, 0), lambda: program.arch_of(cfg),
               lambda: flops.body_params(cfg), lambda: readings._attn(cfg)):
        with pytest.raises(ValueError, match=r"configs/qwen2-vl-7b\.json"):
            fn()


def test_arch_keys_must_be_fields_of_the_programs_config(monkeypatch):
    cfg = dict(conf("qwen2-vl-7b"), sliding_blocks=4)
    monkeypatch.setattr(gqa, "ARCH_KEYS", ("sliding_blocks",))
    with pytest.raises(ValueError, match="sliding_blocks"):
        program.arch_of(cfg)
    monkeypatch.setattr(gqa, "ARCH_KEYS", ("window",))
    with pytest.raises(ValueError, match="needs"):
        program.arch_of(conf("qwen2-vl-7b"))
    assert program.arch_of(dict(conf("qwen2-vl-7b"), window=64)).window == 64


def test_a_new_mla_cell_is_new_files_alone(tmp_path):
    """A copy of the benchmark gains a tiny ``"layout": "mla"``
    configuration, its cell under the document mix and the cell's limits,
    as new files and new entries: the cell runs correct from the copy, the
    whole suite passes on the copy, and no file that was there changes."""
    root = tmp_path / "checkout"
    new = root / BENCH.name
    shutil.copytree(BENCH, new, ignore=shutil.ignore_patterns(
        "__pycache__", ".pytest_cache"))
    for f in ("BENCHMARK.json", "pyproject.toml"):
        shutil.copy(BENCH.parent / f, root)
    (root / "src").symlink_to(BENCH.parent / "src")
    before = {p: p.read_bytes() for p in new.rglob("*") if p.is_file()}
    (new / "configs" / "tiny-mla.json").write_text(json.dumps(TINY_MLA))
    shutil.copy(new / "limits" / "dsmoe16b.unique_docs.json",
                new / "limits" / "tinymla.unique_docs.json")
    b = json.load(open(root / "BENCHMARK.json"))
    b["configs"].append({"name": "tiny-mla", "source": "test",
                         "file": f"{BENCH.name}/configs/tiny-mla.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tinymla.unique_docs",
                           "config": "tiny-mla", "traffic": "unique_docs",
                           "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "dsmoe16b.unique_docs" in m.get("workloads", []):
            m["workloads"].append("tinymla.unique_docs")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    spec = cell.load("tinymla.unique_docs", root)
    spec = spec._replace(mix=dict(spec.mix, **TINY_MIX["unique_docs"]))
    torch.manual_seed(0)
    ctx = cell.Ctx(spec, DRAW_SEED, 1.0, True, torch.device("cpu"),
                   time.perf_counter())
    out = cell.result(ctx, cell.run(ctx))
    assert out["correct"], out["checks"]
    assert "decode_step_ms.tput" in out["metrics"]

    this = f"{BENCH.name}/tests/test_pb_layouts.py::" + \
        test_a_new_mla_cell_is_new_files_alone.__name__
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"{BENCH.name}/tests", "--deselect", this],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    assert " passed" in run.stdout.splitlines()[-1]
    assert all(p.read_bytes() == v for p, v in before.items()
               if p.suffix != ".pyc")
