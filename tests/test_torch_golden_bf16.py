"""Golden logits of gemma3-27b as published (bfloat16) at full width, kept
in tests/data/torch_golden_bf16.json, which the port's chip check
(``chip_smoke.py``) also holds the LM on the card to.

Two cells of ``configs.get("gemma3-27b")`` (d_model 5376, 32/16 heads of
128, d_ff 21 504, vocabulary 262 144, window 1024, qk-norm, gelu), the
depth cut:

  * A: 2 layers (the two local prefix layers; 2 240 M parameters), two
    prompts of 96 tokens, 4 decode steps;
  * B: 8 layers (the prefix, then one block of five locals and a global
    layer; 4 711 M parameters), one prompt of 1040 tokens, so that the
    local layers' 1024-row ring caches wrap, 4 decode steps.

Weights ``seeded_numpy_params(cfg, 0)`` rounded to bf16
(``seeded_params``, chunk by chunk); prompts from
``np.random.default_rng(1)``.  The reference runs each cell three times
on the CPU: in float32 on the rounded weights (the oracle, greedy: its
tokens are the decode steps' inputs in the other runs) and in bf16
under its two XLA lowerings (with and without excess precision).  For
each logits row (the prefill's last token, then each step's) the file
keeps the oracle's top-33 indices and values, its largest |logit|, its
greedy token and top-2 margin, and the two bf16 runs' values at those
indices; a crc32 of the weights' bf16 bits.  Cell B also keeps, for
layers 0 (a local prefix layer) and 7 (the global layer), one layer's
prefill output error in bf16 against f32 on the same input (the oracle's
input to the layer, rounded to bf16 for the bf16 run), relative to the
largest |output|: what the card's full-depth run holds its layers to.

The bound is tests/test_torch_bf16.py's: in each phase (the prefill, each
step) the port's largest |logit - oracle's| over the stored indices at
most 2 x the reference's (the larger lowering's) plus 1e-3 x max
|oracle|; greedy tokens equal where the oracle's top-2 margin exceeds 4 x
the larger error of the row.  This test holds the port's plain path
(``device="cpu"``, bf16) to cell A (about 70 s and 5 GB in one
process); cell B is held on the card only.

The file also keeps ``train_cell``: the reference's loss (step 0, no
update) of cell A's model and weights on ``train.loop.train``'s first
batch (8 x 128, kept) in float32 and bf16, whose gap bounds the card's
2-layer bf16 training; and ``train_gap``: the reference's losses over 3
AdamW steps of the reduced config in bf16 and float32.

Regenerate with ``PYTHONPATH=src python tests/test_torch_golden_bf16.py``
(one process a cell and run, on 8 CPU cores: cell A about 3 minutes and
16 GB, cell B about 11 minutes and 37 GB, ``train`` about 4 minutes and
16 GB), or name them (``A``, ``B``, ``train``).
"""
import dataclasses
import json
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import seeded_params  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_bf16.json"
ARCH = "gemma3-27b"
COMMON = dict(arch=ARCH, seed=0, input_seed=1, top=33)
CELLS = {"A": dict(num_layers=2, batch=2, prompt=96, steps=4),
         "B": dict(num_layers=8, batch=1, prompt=1040, steps=4)}
LAYER_ERRORS = {"B": (0, 7)}        # layers whose one-layer error is kept
RATIO, FLOOR, GREEDY_MARGIN = 2.0, 1e-3, 4.0    # tests/test_torch_bf16.py
RUNS = ("oracle", "bf16", "bf16_no_excess")


def cell_config(configs, cell: str):
    """A cell's config from a config module (either package): gemma3-27b
    as published, bf16, its depth cut."""
    cfg = configs.get(ARCH)
    n = CELLS[cell]["num_layers"]
    assert cfg.param_dtype == "bfloat16"
    return dataclasses.replace(cfg, name=f"{cfg.name}-{n}l", num_layers=n)


def cell_prompts(cfg, cell: str) -> np.ndarray:
    c = CELLS[cell]
    rng = np.random.default_rng(COMMON["input_seed"])
    return rng.integers(0, cfg.vocab_size, (c["batch"], c["prompt"])
                        ).astype(np.int32)


def weights_crc(tree) -> int:
    """crc32 of every leaf's bf16 bits in ``pytree.flatten`` order (a tree
    of host tensors, numpy arrays or ``Leaf``s)."""
    crc = 0
    for _, x in flatten(tree):
        if hasattr(x, "numpy") and not isinstance(x, torch.Tensor):
            a = x.numpy()                              # a Leaf: raw bits
        else:
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
            a = t.contiguous().view(torch.int16).numpy()
        crc = zlib.crc32(np.ascontiguousarray(a).view(np.uint8), crc)
    return crc


def phases(cell: str) -> list:
    """(label, row slice) of each phase: the prefill, then each step."""
    b = CELLS[cell]["batch"]
    return [("prefill", slice(0, b))] + [
        (f"step {t}", slice(b * (t + 1), b * (t + 2)))
        for t in range(CELLS[cell]["steps"])]


def check_cell(rows: np.ndarray, golden: dict, cell: str) -> dict:
    """Hold the port's (N, V) logits rows to a golden cell by the bound;
    returns each phase's (port, reference) distances and the greedy rows
    compared.  Raises AssertionError with the phase."""
    want = golden["rows"]
    assert len(rows) == len(want), (len(rows), len(want))
    out, sure = {}, 0
    for label, sl in phases(cell):
        p_err = r_err = top = 0.0
        for i in range(sl.start, sl.stop):
            w = want[i]
            idx, o = np.asarray(w["top_idx"]), np.asarray(w["top_val"])
            p_row = float(np.abs(rows[i][idx].astype(np.float64) - o).max())
            r_row = max(float(np.abs(np.asarray(w[k]) - o).max())
                        for k in RUNS[1:])
            p_err, r_err = max(p_err, p_row), max(r_err, r_row)
            top = max(top, w["max_abs"])
            if w["margin"] > GREEDY_MARGIN * max(p_row, r_row):
                sure += 1
                assert int(np.argmax(rows[i])) == w["greedy"], (
                    f"cell {cell} {label} row {i}: greedy "
                    f"{int(np.argmax(rows[i]))}, the oracle's {w['greedy']}")
        lim = RATIO * r_err + FLOOR * top
        assert p_err <= lim, (f"cell {cell} {label}: the port's bf16 is "
                              f"{p_err:.4g} from the oracle, the "
                              f"reference's {r_err:.4g} (limit {lim:.4g})")
        out[label] = (p_err, r_err)
    assert sure >= 1, f"cell {cell}: no greedy token compared"
    out["greedy_rows"] = sure
    return out


def run_port(model, prompts: np.ndarray, teacher: np.ndarray) -> np.ndarray:
    """A cell on a port ``LM``: (1 + steps) * B logits rows, f32."""
    dev = model.device
    caches = model.init_caches(prompts.shape[0],
                               prompts.shape[1] + teacher.shape[0])
    logits, caches = model.prefill(
        {"tokens": torch.from_numpy(prompts).to(dev)}, caches)
    rows = [logits.float().cpu().numpy()]
    for t, tok in enumerate(teacher):
        logits, caches = model.decode_step(torch.from_numpy(tok).to(dev),
                                           caches, prompts.shape[1] + t)
        rows.append(logits.float().cpu().numpy())
    return np.concatenate(rows)


def test_port_plain_path_matches_golden_bf16_cell_a():
    golden = json.loads(GOLDEN.read_text())
    assert golden["common"] == COMMON and golden["cells_config"] == CELLS
    cell = golden["cells"]["A"]
    cfg = cell_config(t_configs, "A")
    assert cfg.param_count()[0] == cell["params"]
    model = LM(cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    tree = seeded_params(cfg, COMMON["seed"])
    assert weights_crc(tree) == cell["weights_crc32"]
    params_from_numpy(model, tree)        # shares the bf16 tensors
    del tree
    teacher = np.asarray(cell["teacher"], np.int32)
    rows = run_port(model, cell_prompts(cfg, "A"), teacher)
    assert rows.shape == ((1 + CELLS["A"]["steps"]) * CELLS["A"]["batch"],
                          cfg.padded_vocab())
    assert np.isfinite(rows).all()
    check_cell(rows, cell, "A")


def test_golden_bf16_file_holds_both_cells():
    golden = json.loads(GOLDEN.read_text())
    assert sorted(golden["cells"]) == sorted(CELLS)
    for name, cell in golden["cells"].items():
        c = CELLS[name]
        cfg = cell_config(t_configs, name)
        assert cell["params"] == cfg.param_count()[0]
        assert len(cell["rows"]) == (1 + c["steps"]) * c["batch"]
        assert np.asarray(cell["teacher"]).shape == (c["steps"], c["batch"])
        for r in cell["rows"]:
            assert len(r["top_idx"]) == COMMON["top"]
            assert all(len(r[k]) == COMMON["top"] for k in RUNS[1:])
            assert r["margin"] >= 0 and r["greedy"] == r["top_idx"][0]
        assert sorted(cell.get("layer_err", {})) == sorted(
            str(li) for li in LAYER_ERRORS.get(name, ()))
    gap = golden["train_gap"]
    assert all(len(v) == gap["steps"] for v in gap["losses"].values())
    assert 0 < gap["gap"] < 0.05
    tc = golden["train_cell"]
    assert tc["weights_crc32"] == golden["cells"][tc["cell"]]["weights_crc32"]
    assert sorted(tc["loss"]) == sorted(RUNS) and tc["gap"] > 0
    for v in tc["batch"].values():
        assert np.asarray(v).shape == (tc["batch_size"], tc["seq"])


# ----------------------------------------------------------- regenerate

def reference_run(cell: str, run: str) -> dict:
    """One run of a cell on the reference (CPU): the oracle (float32 on
    the rounded weights; greedy) or a bf16 lowering fed the oracle's
    tokens."""
    import jax
    import jax.numpy as jnp
    c = CELLS[cell]
    tcfg = cell_config(t_configs, cell)
    oracle = run == "oracle"
    model, params, opts, crc = _reference_model(cell, run)
    jcfg = model.cfg
    prompts = cell_prompts(tcfg, cell)
    teacher = None if oracle else np.asarray(
        json.loads(Path(_part(cell, "oracle")).read_text())["teacher"],
        np.int32)
    caches = model.init_caches(c["batch"], c["prompt"] + c["steps"])
    prefill = jax.jit(model.prefill, compiler_options=opts)
    decode = jax.jit(model.decode_step, compiler_options=opts)
    logits, caches = prefill(params, {"tokens": jnp.asarray(prompts)},
                             caches)
    rows, toks = [np.asarray(logits, np.float32)], []
    for t in range(c["steps"]):
        tok = (np.argmax(rows[-1], -1).astype(np.int32) if oracle
               else teacher[t])
        toks.append(tok.tolist())
        logits, caches = decode(params, jnp.asarray(tok), caches,
                                jnp.int32(c["prompt"] + t))
        rows.append(np.asarray(logits, np.float32))
    out = {"rows": np.concatenate(rows), "teacher": toks, "crc": crc}
    if cell in LAYER_ERRORS:
        out["layer_out"] = _layer_outputs(model, params, jcfg, prompts,
                                          cell, oracle, opts)
    return out


def _reference_model(cell: str, run: str) -> tuple:
    """(the reference's LM, its parameters on the CPU, the run's XLA
    options, the weights' crc32) of a cell and run.  The oracle's tree
    holds the bf16 leaves as they are but the embedding in float32: a
    float32 activation times a bf16 weight is the float32 product of the
    widened weight, and only the embedding's row lookup and scale would
    stay in bf16."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro import configs as j_configs
    from repro.models import transformer as j_tf
    jcfg = cell_config(j_configs, cell)
    tree = seeded_params(cell_config(t_configs, cell), COMMON["seed"])
    crc = weights_crc(tree)
    oracle = run == "oracle"

    def to_jax(path, t):
        a = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if oracle and path == ("embed",):
            a = a.astype(np.float32)
        return jnp.asarray(a)

    params = _map_path(tree, to_jax)     # frees each bf16 leaf as it goes
    del tree
    if oracle:
        jcfg = dataclasses.replace(jcfg, param_dtype="float32")
    opts = {"bf16_no_excess": {"xla_allow_excess_precision": False}}.get(
        run, {})
    return j_tf.LM(jcfg), params, opts, crc


TRAIN_CELL = dict(cell="A", batch_size=8, seq=128, seed=0)


def reference_train_loss(run: str) -> dict:
    """The reference's loss (step 0, no update) of cell A's model and
    weights on ``train.loop.train``'s first batch (``make_pipeline``,
    TRAIN_CELL's shape and seed; kept in the file, since the pipeline's
    draws differ between numpy versions)."""
    import jax
    import jax.numpy as jnp
    from repro.data import make_pipeline
    t = TRAIN_CELL
    model, params, opts, crc = _reference_model(t["cell"], run)
    batch = next(make_pipeline(model.cfg.vocab_size, t["batch_size"],
                               t["seq"], seed=t["seed"]))
    loss = jax.jit(model.loss, compiler_options=opts)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), "crc": crc,
            "batch": {k: np.asarray(v).tolist() for k, v in batch.items()}}


def _map_path(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, each leaf
    replaced in place as it is mapped (its old value freed then)."""
    for k in (list(tree) if isinstance(tree, dict) else range(len(tree))):
        v = tree[k]
        if isinstance(v, (dict, list)):
            _map_path(v, fn, path + (k,))
        else:
            tree[k] = None
            tree[k] = fn(path + (k,), v)
            del v
    return tree


def _layer_outputs(model, params, cfg, prompts, cell, oracle, opts) -> dict:
    """{layer: (its input, its prefill output)} of the kept layers; the
    bf16 runs take the oracle's input to each layer, rounded."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as j_tf
    from repro_torch.models.weights import layer_source, layer_specs
    specs = layer_specs(cfg)
    x, pos = model._embed_inputs(params, {"tokens": jnp.asarray(prompts)})
    inputs = (None if oracle else np.load(_part(cell, "oracle")
                                           + ".inputs.npz"))
    outs, keep = {}, {}
    b, s = prompts.shape
    for li in range(max(LAYER_ERRORS[cell]) + 1):
        where, i = layer_source(cfg, li)
        p = (params["prefix"][i] if where == "prefix" else
             jax.tree_util.tree_map(lambda a: a[i], params["blocks"][where]))
        if li in LAYER_ERRORS[cell]:
            xin = x if oracle else jnp.asarray(inputs[str(li)]).astype(
                model.dtype)
            cache = j_tf.init_layer_cache(cfg, specs[li], b, s, model.dtype)
            y, _ = jax.jit(lambda p, x, c: j_tf.apply_layer_prefill(
                p, x, c, cfg, specs[li]), compiler_options=opts)(p, xin,
                                                                  cache)
            outs[str(li)] = np.asarray(y, np.float32)
            if oracle:
                keep[str(li)] = np.asarray(x, np.float32)
        if oracle:
            x = j_tf.apply_layer_full(p, x, cfg, specs[li], pos)
    if oracle:
        np.savez(_part(cell, "oracle") + ".inputs.npz", **keep)
    return outs


PARTS = Path(__file__).resolve().parents[1] / "build" / "golden_bf16"


TRAIN_GAP = dict(steps=3, batch=8, seq=128, lr=3e-4, seed=0)


def reference_train_gap() -> dict:
    """The reference's training losses on reduced gemma3-27b in bf16 (both
    lowerings) and in float32 on the same rounded weights, over
    ``TRAIN_GAP["steps"]`` AdamW steps with ``train.loop.train``'s
    schedule and batches; ``gap`` the largest |bf16 - f32| loss of a
    step, which the card's bf16 training is held to at full width."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from repro import configs as j_configs
    from repro.data import make_pipeline
    from repro.models import transformer as j_tf
    from repro.optim import AdamW, cosine_with_warmup
    from repro.train import train_step as j_ts
    g = TRAIN_GAP
    tcfg = dataclasses.replace(t_configs.get(ARCH).reduced(),
                               param_dtype="bfloat16")
    bits = _map_path(seeded_params(tcfg, g["seed"]), lambda _, t: t.view(
        torch.int16).numpy().view(ml_dtypes.bfloat16))
    pipe = make_pipeline(tcfg.vocab_size, g["batch"], g["seq"],
                         seed=g["seed"])
    batches = [next(pipe) for _ in range(g["steps"])]
    losses = {}
    for run in RUNS:
        dt = np.float32 if run == "oracle" else ml_dtypes.bfloat16
        cfg = dataclasses.replace(j_configs.get(ARCH).reduced(),
                                  param_dtype="float32" if run == "oracle"
                                  else "bfloat16")
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(dt)),
                                        bits)
        opt = AdamW(learning_rate=g["lr"], schedule=cosine_with_warmup(
            min(20, g["steps"] // 10 + 1), g["steps"]))
        state = j_ts.TrainState(params, opt.init(params), None)
        opts = ({"xla_allow_excess_precision": False}
                if run == "bf16_no_excess" else {})
        step = jax.jit(j_ts.make_train_step(j_tf.LM(cfg), opt),
                       compiler_options=opts)
        losses[run] = []
        for b in batches:
            state, met = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            losses[run].append(float(met["loss"]))
    gap = max(abs(a - b) for r in RUNS[1:]
              for a, b in zip(losses[r], losses["oracle"]))
    return {**g, "losses": losses, "gap": gap}


def _part(cell: str, run: str) -> str:
    """A run's result file (the checkout's ``build/``, which git
    ignores)."""
    PARTS.mkdir(parents=True, exist_ok=True)
    return str(PARTS / f"{cell}.{run}.json")


def _summaries(cell: str) -> dict:
    """A cell's stored record from its three runs' part files."""
    parts = {r: json.loads(Path(_part(cell, r)).read_text()) for r in RUNS}
    crcs = {p["crc"] for p in parts.values()}
    assert len(crcs) == 1, crcs
    rows = {r: np.load(_part(cell, r) + ".npz")["rows"] for r in RUNS}
    top = COMMON["top"]
    out = []
    for i, o in enumerate(rows["oracle"]):
        idx = np.argsort(-o, kind="stable")[:top]
        rec = {"top_idx": idx.tolist(),
               "top_val": o[idx].astype(float).tolist(),
               "max_abs": float(np.abs(o).max()), "greedy": int(idx[0]),
               "margin": float(o[idx[0]]) - float(o[idx[1]])}
        for r in RUNS[1:]:
            rec[r] = rows[r][i][idx].astype(float).tolist()
        out.append(rec)
    cfg = cell_config(t_configs, cell)
    rec = {"params": cfg.param_count()[0], "weights_crc32": crcs.pop(),
           "teacher": parts["oracle"]["teacher"], "rows": out}
    if cell in LAYER_ERRORS:
        outs = {r: np.load(_part(cell, r) + ".layers.npz") for r in RUNS}
        rec["layer_err"] = {
            li: max(float(np.abs(outs[r][li].astype(np.float64)
                                 - outs["oracle"][li]).max())
                    for r in RUNS[1:]) / float(np.abs(outs["oracle"][li])
                                               .max())
            for li in outs["oracle"].files}
    return rec


def _train_summary() -> dict:
    parts = {r: json.loads(Path(_part("train", r)).read_text())
             for r in RUNS}
    o = parts["oracle"]["loss"]
    assert len({p["crc"] for p in parts.values()}) == 1
    return {**TRAIN_CELL, "weights_crc32": parts["oracle"]["crc"],
            "batch": parts["oracle"]["batch"],
            "loss": {r: p["loss"] for r, p in parts.items()},
            "gap": max(abs(parts[r]["loss"] - o) for r in RUNS[1:])}


def _generate(cell: str, run: str) -> None:
    if cell == "train":
        Path(_part(cell, run)).write_text(json.dumps(
            reference_train_loss(run)))
        return
    res = reference_run(cell, run)
    np.savez(_part(cell, run) + ".npz", rows=res.pop("rows"))
    if "layer_out" in res:
        np.savez(_part(cell, run) + ".layers.npz", **res.pop("layer_out"))
    Path(_part(cell, run)).write_text(json.dumps(res))


if __name__ == "__main__":
    cells = sys.argv[1:] or sorted(CELLS) + ["train"]
    if len(cells) == 2 and cells[1] in RUNS:          # one run (a child)
        _generate(*cells)
        sys.exit(0)
    for cell in cells:                  # one process a run (memory)
        for run in RUNS:
            subprocess.run([sys.executable, __file__, cell, run], check=True)
    golden = (json.loads(GOLDEN.read_text()) if GOLDEN.exists() else
              {"source": "repro.models.transformer.LM on the CPU, float32 "
                         "and bf16; procedure in "
                         "tests/test_torch_golden_bf16.py",
               "common": COMMON, "cells_config": CELLS, "cells": {}})
    golden["common"], golden["cells_config"] = COMMON, CELLS
    for cell in cells:
        if cell == "train":
            golden["train_cell"] = _train_summary()
        else:
            golden["cells"][cell] = _summaries(cell)
    golden["train_gap"] = reference_train_gap()
    golden["cells"] = {c: golden["cells"][c] for c in sorted(golden["cells"])}
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(golden) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
