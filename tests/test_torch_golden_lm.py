"""Golden logits of the reference LM at qwen3-4b's full width, kept in
tests/data/torch_golden_lm.json, which the port's chip check
(``chip_smoke.py``) also holds the LM on the card to.

The cell: ``configs.get("qwen3-4b")`` with its depth cut to 2 layers
(d_model 2560, 32/8 heads of 128, d_ff 9728, vocab 151 936 padded to
152 064: 591 M parameters), weights ``seeded_numpy_params(cfg, 0)``, two
prompts of 64 tokens, then 4 teacher-forced decode steps (inputs from
``np.random.default_rng(1)``).  For each of the 10 logits rows (prefill's
last token, then each step) the file keeps the top-33 indices and values,
the largest |logit|, the sum and the sum of squares, and the greedy
token.

This test runs the port's plain path (``device="cpu"``) on the cell and
holds it to the file: every top-32 logit within ``1e-3 * max |logit|`` of
the row, the ranks whose gaps to both neighbours exceed that tolerance in
the same order, the greedy token equal where the top two are further
apart than it, the sum within the same tolerance and the sum of squares
within 1e-3 relative.  Regenerate the file from the reference (about
20 s and 5 GB) with ``PYTHONPATH=src python tests/test_torch_golden_lm.py``.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_lm.json"
CELL = dict(arch="qwen3-4b", num_layers=2, seed=0, batch=2, prompt=64,
            steps=4, input_seed=1, top=33)


def cell_config(configs):
    """The golden cell's config from a config module (either package)."""
    cfg = configs.get(CELL["arch"])
    return dataclasses.replace(cfg, name=f"{cfg.name}-{CELL['num_layers']}l",
                               num_layers=CELL["num_layers"])


def cell_inputs(vocab: int):
    """(prompts (B, S), teacher-forced tokens (steps, B)) as int32."""
    rng = np.random.default_rng(CELL["input_seed"])
    prompts = rng.integers(0, vocab, (CELL["batch"], CELL["prompt"]))
    teacher = rng.integers(0, vocab, (CELL["steps"], CELL["batch"]))
    return prompts.astype(np.int32), teacher.astype(np.int32)


def summarize(rows: np.ndarray) -> list:
    """The stored summary of each logits row of (N, V) float32."""
    out = []
    for r in np.asarray(rows, np.float32):
        idx = np.argsort(-r, kind="stable")[:CELL["top"]]
        r64 = r.astype(np.float64)
        out.append({"top_idx": idx.tolist(),
                    "top_val": r[idx].astype(float).tolist(),
                    "max_abs": float(np.abs(r).max()),
                    "sum": float(r64.sum()), "sumsq": float((r64 ** 2).sum()),
                    "greedy": int(np.argmax(r))})
    return out


def check_rows(got: np.ndarray, want: list) -> float:
    """Hold (N, V) logits rows to the stored summaries; returns the
    largest |logit - reference| over the stored indices."""
    worst = 0.0
    for i, (r, w) in enumerate(zip(np.asarray(got, np.float32), want)):
        tol = 1e-3 * w["max_abs"]
        idx = np.asarray(w["top_idx"])
        ref = np.asarray(w["top_val"])
        err = np.abs(r[idx] - ref)
        worst = max(worst, float(err.max()))
        assert (err <= tol).all(), f"row {i}: logits off by {err.max()}"
        order = np.argsort(-r, kind="stable")[:len(idx)]
        gaps = -np.diff(ref)                          # ref[k] - ref[k+1]
        for k in range(len(idx) - 1):
            lo = gaps[k - 1] if k else np.inf
            if lo > tol and gaps[k] > tol:
                assert order[k] == idx[k], f"row {i}: rank {k}"
        if gaps[0] > tol:
            assert int(np.argmax(r)) == w["greedy"], f"row {i}: greedy"
        r64 = r.astype(np.float64)
        assert abs(r64.sum() - w["sum"]) <= tol, f"row {i}: sum"
        assert abs((r64 ** 2).sum() - w["sumsq"]) <= 1e-3 * w["sumsq"], \
            f"row {i}: sum of squares"
    return worst


def run_port(model, prompts: np.ndarray, teacher: np.ndarray) -> np.ndarray:
    """The cell on a port ``LM``: (1 + steps) * B logits rows."""
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


def test_port_plain_path_matches_golden_lm():
    golden = json.loads(GOLDEN.read_text())
    assert golden["cell"] == CELL
    cfg = cell_config(t_configs)
    assert cfg.param_count()[0] == 591_144_960
    model = LM(cfg, device="cpu")
    params_from_numpy(model, seeded_numpy_params(cfg, CELL["seed"]))
    prompts, teacher = cell_inputs(cfg.vocab_size)
    rows = run_port(model, prompts, teacher)
    assert rows.shape == ((1 + CELL["steps"]) * CELL["batch"],
                          cfg.padded_vocab())
    assert np.isfinite(rows).all()
    check_rows(rows, golden["rows"])


def reference_rows() -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.models.transformer import LM as JLM
    cfg = cell_config(j_configs)
    model = JLM(cfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, seeded_numpy_params(cell_config(t_configs),
                                         CELL["seed"]))
    prompts, teacher = cell_inputs(cfg.vocab_size)
    caches = model.init_caches(prompts.shape[0],
                               prompts.shape[1] + teacher.shape[0])
    logits, caches = jax.jit(model.prefill)(
        params, {"tokens": jnp.asarray(prompts)}, caches)
    rows = [np.asarray(logits)]
    decode = jax.jit(model.decode_step)
    for t, tok in enumerate(teacher):
        logits, caches = decode(params, jnp.asarray(tok), caches,
                                jnp.int32(prompts.shape[1] + t))
        rows.append(np.asarray(logits))
    return np.concatenate(rows)


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps({
        "source": "repro.models.transformer.LM (jnp attention) on the CPU; "
                  "procedure in tests/test_torch_golden_lm.py",
        "cell": CELL, "rows": summarize(reference_rows())}, indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
