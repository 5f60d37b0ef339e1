"""Golden logits and MoE routing of the reference LM for each model family
at full width, kept in tests/data/torch_golden_substrates.json, which the
port's chip check (``chip_smoke.py``) also holds the LM on the card to.

The cells: each family's config at its published width with the depth
cut to 2 decoder layers (a pass of its prefix and block pattern):
deepseek-v2-lite-16b (a dense MLA layer, then an MoE/MLA one: dropless),
deepseek-moe-16b (dense, then MoE with capacity 1.25), mamba2-780m,
gemma2-9b (LOCAL then GLOBAL, soft caps 50 and 30), qwen2-vl-7b and
seamless-m4t-medium (2 encoder and 2 decoder layers).  Weights
``seeded_numpy_params(cfg, 0)``; two prompts of 96 tokens (three chunks
of 32 in Mamba2's prefill), then 4 teacher-forced decode steps (inputs
from ``np.random.default_rng(1)``).  seamless reads frame embeddings (2,
16, d_model) drawn after them from the same generator (zero frames
would zero the encoder's output and leave cross-attention unchecked);
qwen2-vl also runs ``forward`` with patch embeddings (2, 8, d_model) and
three distinct t/h/w position streams, of which the rows at positions 7,
8 and 95 are kept.

For each logits row the file keeps the top-33 indices and values, the
largest |logit|, the sum, the sum of squares and the greedy token (as
tests/test_torch_golden_lm.py).  For each MoE layer call (the prefill's,
then each step's) it keeps every token's top-k experts, its top-k margin
(the k-th gate less the (k+1)-th) and the dropped (token, slot) pairs
per expert.

This test runs the port's plain path (``device="cpu"``) on the cells
whose weights fit in about 2.5 GB (mamba2, seamless) and holds it to the
file as tests/test_torch_golden_lm.py does; the larger cells are held on
the card only.  Regenerate the file from the reference (one process a
cell, up to about 13 GB for qwen2-vl) with
``PYTHONPATH=src python tests/test_torch_golden_substrates.py [arch ...]``.
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
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402

from test_torch_golden_lm import check_rows, summarize  # noqa: E402

GOLDEN = (Path(__file__).resolve().parent / "data"
          / "torch_golden_substrates.json")
COMMON = dict(num_layers=2, seed=0, batch=2, prompt=96, steps=4,
              input_seed=1, top=33, frames=16, patches=8,
              forward_rows=[7, 8, 95])
CELLS = {"mamba2-780m": {}, "seamless-m4t-medium": {"encoder_layers": 2},
         "deepseek-moe-16b": {}, "deepseek-v2-lite-16b": {},
         "gemma2-9b": {}, "qwen2-vl-7b": {}}
ON_CPU = ("mamba2-780m", "seamless-m4t-medium")
FRAMES, PATCHES = COMMON["frames"], COMMON["patches"]
FORWARD_ROWS = COMMON["forward_rows"]
MARGIN = 1e-4      # routing compared where the top-k margin exceeds it


def cell_config(configs, arch: str):
    """A golden cell's config from a config module (either package)."""
    cfg = configs.get(arch)
    kw = dict(num_layers=COMMON["num_layers"], **CELLS[arch])
    return dataclasses.replace(cfg, name=f"{cfg.name}-{kw['num_layers']}l",
                               **kw)


def cell_inputs(cfg) -> dict:
    """prompts (B, S) and teacher-forced tokens (steps, B) int32; frames
    (B, 16, D) of an encoder-decoder cell; patch embeddings (B, 8, D) and
    (3, B, S) positions of an M-RoPE cell."""
    rng = np.random.default_rng(COMMON["input_seed"])
    b, s = COMMON["batch"], COMMON["prompt"]
    out = {"prompts": rng.integers(0, cfg.vocab_size, (b, s)).astype(
               np.int32),
           "teacher": rng.integers(0, cfg.vocab_size, (COMMON["steps"], b)
                                   ).astype(np.int32)}
    if cfg.is_encdec:
        out["frame_embeds"] = rng.standard_normal((b, FRAMES, cfg.d_model),
                                                  np.float32)
    if cfg.mrope_sections is not None:
        out["patch_embeds"] = 0.1 * rng.standard_normal(
            (b, PATCHES, cfg.d_model), np.float32)
        t = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        # a vision grid over the patches (h, w of 2 x 4), text after it
        h = np.where(t < PATCHES, t // 4, t - PATCHES + 2)
        w = np.where(t < PATCHES, t % 4, t - PATCHES + 4)
        out["positions"] = np.stack([t, h, w]).astype(np.int32)
    return out


def routing_record(experts: np.ndarray, gates: np.ndarray,
                   drops: np.ndarray) -> dict:
    """One MoE call's stored routing: each token's top-k experts (sorted),
    its top-k margin, and the dropped pairs per expert."""
    k = experts.shape[1]
    g = -np.sort(-gates.astype(np.float64), axis=-1)
    return {"experts": np.sort(experts, axis=-1).tolist(),
            "margin": (g[:, k - 1] - g[:, k]).tolist(),
            "drops": np.asarray(drops).tolist()}


def check_routing(got: list, want: list) -> dict:
    """Hold the port's routing records to the golden ones: equal calls
    and shapes, each token's expert set equal where its margin exceeds
    MARGIN, drops per expert equal when no token of the call is a near
    tie.  Returns the counts of tokens compared, of near ties and of the
    calls whose drops differ beside a near tie."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} MoE calls, golden {len(want)}")
    compared = near = drops_differ = 0
    for c, (g, w) in enumerate(zip(got, want)):
        ge, we = np.asarray(g["experts"]), np.asarray(w["experts"])
        if ge.shape != we.shape:
            raise AssertionError(f"call {c}: routing {ge.shape} vs "
                                 f"{we.shape}")
        sure = np.asarray(w["margin"]) > MARGIN
        near += int((~sure).sum())
        compared += int(sure.sum())
        bad = np.nonzero(sure & (ge != we).any(-1))[0]
        if len(bad):
            raise AssertionError(f"call {c}: tokens {bad[:5].tolist()} "
                                 f"routed to {ge[bad[0]]}, golden "
                                 f"{we[bad[0]]}")
        if g["drops"] != w["drops"]:
            if sure.all():
                raise AssertionError(f"call {c}: drops {g['drops']}, "
                                     f"golden {w['drops']}")
            drops_differ += 1
    return {"tokens": compared, "near_ties": near,
            "drops_differ_near_a_tie": drops_differ}


class RoutingTap:
    """While entered, records every ``moe_mlp`` call of the port
    (``repro_torch.models.moe.route``) as a routing record."""

    def __init__(self, moe):
        self.moe, self.records = moe, []

    def __enter__(self):
        self.route = self.moe.route

        def route(p, x2, cfg):
            r = self.route(p, x2, cfg)
            drops = torch.bincount(r.expert[~r.keep],
                                   minlength=cfg.num_experts)
            self.records.append(routing_record(
                r.expert.reshape(-1, cfg.top_k).cpu().numpy(),
                r.gates.cpu().numpy(), drops.cpu().numpy()))
            return r
        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def run_port(model, inputs: dict) -> dict:
    """A cell on a port ``LM``: the logits rows (prefill's last token,
    then each step's) and, for an M-RoPE cell, the forward rows."""
    dev = model.device
    prompts, teacher = inputs["prompts"], inputs["teacher"]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()
             if k not in ("teacher", "positions")}
    batch["tokens"] = batch.pop("prompts")
    caches = model.init_caches(prompts.shape[0],
                               prompts.shape[1] + teacher.shape[0])
    logits, caches = model.prefill(batch, caches)
    rows = [logits.float().cpu().numpy()]
    for t, tok in enumerate(teacher):
        logits, caches = model.decode_step(torch.from_numpy(tok).to(dev),
                                           caches, prompts.shape[1] + t)
        rows.append(logits.float().cpu().numpy())
    out = {"rows": np.concatenate(rows)}
    if "positions" in inputs:
        batch["positions"] = torch.from_numpy(inputs["positions"]).to(dev)
        fwd = model(batch)[:, FORWARD_ROWS]
        out["forward_rows"] = fwd.float().cpu().numpy().reshape(
            -1, fwd.shape[-1])
    return out


@pytest.mark.parametrize("arch", ON_CPU)
def test_port_plain_path_matches_golden_substrates(arch):
    golden = json.loads(GOLDEN.read_text())
    assert golden["common"] == COMMON
    cell = golden["cells"][arch]
    cfg = cell_config(t_configs, arch)
    assert cfg.param_count()[0] == cell["params"]
    model = LM(cfg, device="cpu")
    params_from_numpy(model, seeded_numpy_params(cfg, COMMON["seed"]))
    got = run_port(model, cell_inputs(cfg))
    rows = got["rows"]
    assert rows.shape == ((1 + COMMON["steps"]) * COMMON["batch"],
                          cfg.padded_vocab())
    assert np.isfinite(rows).all()
    check_rows(rows, cell["rows"])


def test_golden_file_covers_every_family():
    golden = json.loads(GOLDEN.read_text())
    assert sorted(golden["cells"]) == sorted(CELLS)
    for arch, cell in golden["cells"].items():
        cfg = cell_config(t_configs, arch)
        assert cell["params"] == cfg.param_count()[0]
        assert len(cell["rows"]) == (1 + COMMON["steps"]) * COMMON["batch"]
        moe = any(s.mlp == "moe" for s in cfg.prefix_layers
                  + cfg.block_pattern)
        assert bool(cell["routing"]) == moe
        if moe:
            # one record a MoE layer a call: the prefill, then the steps
            assert len(cell["routing"]) == 1 + COMMON["steps"]
            assert len(cell["routing"][0]["experts"]) == \
                COMMON["batch"] * COMMON["prompt"]
        assert ("forward_rows" in cell) == (cfg.mrope_sections is not None)
        assert cell["config"] == dict(num_layers=COMMON["num_layers"],
                                      **CELLS[arch])


# ----------------------------------------------------------- regenerate

def reference_cell(arch: str) -> dict:
    """Run a cell on the reference (jnp attention, on the CPU), recording
    each MoE call's routing through ``jax.debug.callback``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.models import moe as j_moe
    from repro.models.transformer import LM as JLM
    cfg = cell_config(j_configs, arch)
    tcfg = cell_config(t_configs, arch)
    model = JLM(cfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, seeded_numpy_params(tcfg, COMMON["seed"]))
    inputs = cell_inputs(tcfg)
    records = []
    moe_mlp = j_moe.moe_mlp

    def tapped(p, x, c):
        x2 = x.reshape(-1, x.shape[-1])
        gates = jax.nn.softmax(x2.astype(jnp.float32) @ p["router"], -1)
        _, idx = jax.lax.top_k(gates, c.top_k)
        e_flat = idx.reshape(-1)
        onehot = jax.nn.one_hot(e_flat, c.num_experts, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - 1,
                                  e_flat[:, None], 1)[:, 0]
        dropped = jnp.sum(onehot * (pos >= j_moe._capacity(
            x2.shape[0], c))[:, None], 0)
        jax.debug.callback(
            lambda i, g, d: records.append(routing_record(
                np.asarray(i), np.asarray(g), np.asarray(d))),
            idx, gates, dropped, ordered=True)
        return moe_mlp(p, x, c)

    j_moe.moe_mlp = tapped
    try:
        batch = {"tokens": jnp.asarray(inputs["prompts"])}
        for k in ("frame_embeds", "patch_embeds"):
            if k in inputs:
                batch[k] = jnp.asarray(inputs[k])
        caches = model.init_caches(COMMON["batch"],
                                   COMMON["prompt"] + COMMON["steps"])
        logits, caches = model.prefill(params, batch, caches)
        rows = [np.asarray(logits)]
        decode = jax.jit(model.decode_step)
        for t, tok in enumerate(inputs["teacher"]):
            logits, caches = decode(params, jnp.asarray(tok), caches,
                                    jnp.int32(COMMON["prompt"] + t))
            rows.append(np.asarray(logits))
        jax.effects_barrier()
        cell = {"config": dict(num_layers=COMMON["num_layers"],
                               **CELLS[arch]),
                "params": tcfg.param_count()[0],
                "rows": summarize(np.concatenate(rows)),
                "routing": list(records)}
        if "positions" in inputs:
            batch["positions"] = jnp.asarray(inputs["positions"])
            fwd = np.asarray(model.forward(params, batch))
            cell["forward_rows"] = summarize(
                fwd[:, FORWARD_ROWS].reshape(-1, fwd.shape[-1]))
    finally:
        j_moe.moe_mlp = moe_mlp
    return cell


if __name__ == "__main__":
    archs = sys.argv[1:]
    if not archs:                       # one process a cell (memory)
        for arch in CELLS:
            subprocess.run([sys.executable, __file__, arch], check=True)
        sys.exit(0)
    golden = (json.loads(GOLDEN.read_text()) if GOLDEN.exists() else
              {"source": "repro.models.transformer.LM (jnp attention) on "
                         "the CPU; procedure in "
                         "tests/test_torch_golden_substrates.py",
               "common": COMMON, "cells": {}})
    golden["common"] = COMMON
    for arch in archs:
        golden["cells"][arch] = reference_cell(arch)
        print(f"{arch}: done", file=sys.stderr)
    golden["cells"] = {a: golden["cells"][a] for a in CELLS
                       if a in golden["cells"]}
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(golden) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
