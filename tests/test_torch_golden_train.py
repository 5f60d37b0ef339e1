"""Golden training numbers of the reference at full width, kept in
tests/data/torch_golden_train.json, which the port's chip check
(``chip_smoke.py`` phase 18) holds the port's training on the card to.

The cells: qwen3-4b, gemma2-9b (LOCAL then GLOBAL, soft caps) and
deepseek-v2-lite-16b (a dense MLA layer, then an MoE/MLA one) at their
published widths with the depth cut to 2 decoder layers.  Weights
``seeded_numpy_params(cfg, 0)``; one batch of 2 x 64 tokens,
``next(make_pipeline(vocab, 2, 64, seed=0))``.  Kept per cell: the loss
and ``grad_norm`` (the global gradient norm) at step 0; for each
gradient leaf (the reference's stacked layout and leaf paths) its norm
and 64 entries at flat indices drawn from ``np.random.default_rng(1)``
leaf after leaf; the batch itself (the pipeline's Zipf draws are not the
same under every numpy version); and the losses of three train steps
(``make_train_step`` with ``AdamW(learning_rate=3e-4)``, microbatches 1,
no compression) on that same batch, i.e. the loss at step 0 and after
AdamW steps 1 and 2.

This test runs the same recipe through the reference and through the
port's plain path (``device="cpu"``) at each cell's REDUCED width and
holds them together (loss within 1e-5 relative, each leaf's norm and
entries within 1e-3 of the leaf's norm, the step losses within 1e-5);
the full-width cells are held on the card only.  Regenerate the file
from the reference (one process a cell, up to about 25 GB for gemma2-9b)
with ``PYTHONPATH=src python tests/test_torch_golden_train.py [arch ...]``.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.models import LM, seeded_numpy_params  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.pytree import flatten, from_parts, parts  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_train.json"
COMMON = dict(num_layers=2, seed=0, batch=2, seq=64, data_seed=0,
              index_seed=1, entries=64, steps=3, learning_rate=3e-4)
CELLS = ("qwen3-4b", "gemma2-9b", "deepseek-v2-lite-16b")


def cell_config(configs, arch, reduced=False):
    cfg = configs.get(arch)
    if reduced:
        return cfg.reduced()
    return dataclasses.replace(cfg, name=f"{cfg.name}-2l",
                               num_layers=COMMON["num_layers"])


def cell_batch(cfg):
    return next(make_pipeline(cfg.vocab_size, COMMON["batch"],
                              COMMON["seq"], seed=COMMON["data_seed"]))


def summarize(grads: dict) -> dict:
    """The kept numbers of a cell's step-0 gradients, {leaf path: array}
    in the reference's leaf order."""
    rng = np.random.default_rng(COMMON["index_seed"])
    leaves, total = {}, 0.0
    for path, g in grads.items():
        g = np.asarray(g, np.float32)
        idx = rng.integers(0, g.size, COMMON["entries"])
        sq = float(np.sum(np.square(g.astype(np.float64))))
        total += sq
        leaves[path] = {"norm": sq ** 0.5, "idx": idx.tolist(),
                        "vals": g.reshape(-1)[idx].tolist(),
                        "shape": list(g.shape)}
    return {"grad_norm": total ** 0.5, "leaves": leaves}


def port_cell(cfg, device, nb=None) -> dict:
    """The recipe through the port on ``device`` (on the batch ``nb``, or
    the pipeline's)."""
    tree = seeded_numpy_params(cfg, COMMON["seed"])
    nb = cell_batch(cfg) if nb is None else nb
    model = LM(cfg, device=device)
    opt = AdamW(learning_rate=COMMON["learning_rate"])
    state = t_ts.init_state(model, opt, tree)
    del tree
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in nb.items()}
    flat = parts(state.params)
    loss = model.loss(batch)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, flat)]
    out = summarize({p: leaf.numpy() for p, leaf in
                     flatten(from_parts(state.params, gs))})
    del gs
    step = t_ts.make_train_step(model, opt)
    out["loss"] = []
    for _ in range(COMMON["steps"]):
        state, met = step(state, batch)
        out["loss"].append(float(met["loss"]))
    return out


def reference_cell(arch: str, reduced: bool = False) -> dict:
    """The recipe through the reference (JAX); the cell keeps its batch,
    whose Zipf draws numpy does not promise to repeat across versions."""
    import jax
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.checkpoint.checkpointer import _leaf_paths
    from repro.models import transformer as j_tf
    from repro.optim import AdamW as JAdamW
    from repro.train import train_step as j_ts
    cfg = cell_config(j_configs, arch, reduced)
    params = jax.tree_util.tree_map(jnp.asarray, seeded_numpy_params(
        cell_config(t_configs, arch, reduced), COMMON["seed"]))
    model = j_tf.LM(cfg)
    nb = cell_batch(cfg)
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    _, g = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    names, leaves, _ = _leaf_paths(g)
    out = summarize(dict(zip(names, leaves)))
    out["batch"] = {k: v.tolist() for k, v in nb.items()}
    del g, leaves
    opt = JAdamW(learning_rate=COMMON["learning_rate"])
    state = j_ts.TrainState(params, opt.init(params), None)
    del params
    step = jax.jit(j_ts.make_train_step(model, opt), donate_argnums=(0,))
    out["loss"] = []
    for _ in range(COMMON["steps"]):
        state, met = step(state, batch)
        out["loss"].append(float(met["loss"]))
    return out


def check_cell(got: dict, want: dict, loss_rtol: float, step_rtol: float,
               leaf_tol: float) -> dict:
    """Hold ``got`` to ``want``: step-0 loss within ``loss_rtol``, the
    later losses within ``step_rtol`` (relative), ``grad_norm`` and each
    leaf's norm within ``leaf_tol`` relative and each kept entry within
    ``leaf_tol`` of its leaf's norm.  Returns the largest errors."""
    assert sorted(got["leaves"]) == sorted(want["leaves"])
    err = {"loss": abs(got["loss"][0] - want["loss"][0]) / abs(
        want["loss"][0])}
    assert err["loss"] <= loss_rtol, (got["loss"], want["loss"])
    err["steps"] = max(abs(a - b) / abs(b) for a, b in
                       zip(got["loss"][1:], want["loss"][1:]))
    assert err["steps"] <= step_rtol, (got["loss"], want["loss"])
    err["grad_norm"] = abs(got["grad_norm"] - want["grad_norm"]) / want[
        "grad_norm"]
    assert err["grad_norm"] <= leaf_tol
    err["leaf_norm"] = err["entries"] = 0.0
    for path, w in want["leaves"].items():
        g = got["leaves"][path]
        assert g["idx"] == w["idx"], path
        scale = max(w["norm"], 1e-30)
        e = abs(g["norm"] - w["norm"]) / scale
        assert e <= leaf_tol, (path, g["norm"], w["norm"])
        d = np.max(np.abs(np.subtract(g["vals"], w["vals"]))) / scale
        assert d <= leaf_tol, (path, d)
        err["leaf_norm"] = max(err["leaf_norm"], e)
        err["entries"] = max(err["entries"], float(d))
    return err


def tree_shapes(cfg) -> dict:
    """{leaf path: shape} of the reference's parameter tree of ``cfg``
    (no encoder), without allocating it."""
    from repro_torch.models import weights as W

    def z(init, lead=()):
        return np.broadcast_to(np.uint8(0), lead + tuple(init.shape))
    tree = W._map(W.top_inits(cfg), z)
    tree["prefix"] = [W._map(W.layer_inits(cfg, s), z)
                      for s in cfg.prefix_layers]
    tree["blocks"] = {
        f"l{i}": W._map(W.layer_inits(cfg, s, cross=cfg.is_encdec),
                        lambda x: z(x, (cfg.num_blocks,)))
        for i, s in enumerate(cfg.block_pattern)}
    return {p: list(a.shape) for p, a in flatten(tree)}


def test_golden_file_holds_every_cell():
    golden = json.loads(GOLDEN.read_text())
    assert golden["common"] == COMMON
    assert sorted(golden["cells"]) == sorted(CELLS)
    for arch, cell in golden["cells"].items():
        shapes = tree_shapes(cell_config(t_configs, arch))
        assert {p: v["shape"] for p, v in cell["leaves"].items()} == shapes
        assert len(cell["loss"]) == COMMON["steps"]
        assert all(np.isfinite(cell["loss"])) and cell["grad_norm"] > 0
        assert cell["loss"][2] < cell["loss"][0], arch
        nb = cell_batch(cell_config(t_configs, arch))
        assert {k: np.asarray(v).shape for k, v in cell["batch"].items()} \
            == {k: v.shape for k, v in nb.items()}


@pytest.mark.parametrize("arch", CELLS)
def test_reduced_cells_match_the_reference(arch):
    """The recipe at reduced width through both packages (the port on the
    CPU), held as the card holds the full-width cells, tighter."""
    want = reference_cell(arch, reduced=True)
    got = port_cell(cell_config(t_configs, arch, reduced=True), "cpu")
    check_cell(got, want, 1e-5, 1e-5, 1e-3)


if __name__ == "__main__":
    archs = sys.argv[1:]
    if not archs:          # one process a cell: each frees its memory
        for a in CELLS:
            subprocess.run([sys.executable, __file__, a], check=True)
        sys.exit(0)
    data = (json.loads(GOLDEN.read_text()) if GOLDEN.exists()
            else {"common": COMMON, "cells": {}})
    data["common"] = COMMON
    for a in archs:
        data["cells"][a] = reference_cell(a)
        print(a, data["cells"][a]["loss"], data["cells"][a]["grad_norm"],
              flush=True)
    GOLDEN.write_text(json.dumps(data, indent=1) + "\n")
