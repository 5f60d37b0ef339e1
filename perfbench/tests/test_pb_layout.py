"""The harness is driven by its files: a configuration, a mix, limits and
a metric dropped in as new files, with a new entry in BENCHMARK.json,
make a cell that runs; every entry of the committed BENCHMARK.json has its
files; the generator is deterministic in the seed."""
import json
import shutil

import numpy as np
import pytest
import torch

from conftest import BENCH, CELLS, TINY, TINY_MIX
from pbcore import cell, traffic

ROOT = BENCH.parent


def bench() -> dict:
    return json.load(open(ROOT / "BENCHMARK.json"))


def test_every_entry_has_its_files():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file(), c["name"]
    for w in b["workloads"]:
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(cell.reader(m["name"])), m["name"]
    for name in CELLS:
        c = cell.load(name)
        assert c.end_to_end and c.per_layer
        assert {"setup_s"} < {m["name"] for m in c.end_to_end}
        moved = {m["moves"] for m in c.per_layer}
        assert moved <= {m["name"] for m in c.end_to_end}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A tiny dense configuration, a mix and a per-layer metric, each a new
    file, and their entries: the cell runs and reports the new metric,
    and no file that was there is edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / BENCH.name).rglob("*")
              if p.is_file()}
    conf = dict(json.load(open(BENCH / "configs" / "qwen2-vl-7b.json")),
                **TINY["qwen2-vl-7b"], name="tiny-dense")
    (tmp_path / BENCH.name / "configs" / "tiny-dense.json").write_text(
        json.dumps(conf))
    mix = dict(json.load(open(BENCH / "mixes" / "chat_prefix.json")),
               **TINY_MIX["chat_prefix"])
    (tmp_path / BENCH.name / "mixes" / "tiny_chat.json").write_text(
        json.dumps(mix))
    (tmp_path / BENCH.name / "limits" / "tiny.chat.json").write_text(
        json.dumps({"logit_err": 1e-4}))
    (tmp_path / BENCH.name / "metrics" / "batches.tiny.py").write_text(
        "def read(rec):\n    return float(len(rec['round_shapes']))\n")
    b = bench()
    b["configs"].append({"name": "tiny-dense", "source": "test",
                         "file": f"{BENCH.name}/configs/tiny-dense.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny.chat", "config": "tiny-dense",
                           "traffic": "tiny_chat", "chips": 1, "why": "t"})
    b["end_to_end"][0]["workloads"].append("tiny.chat")
    b["per_layer"].append({"name": "batches.tiny", "unit": "batches",
                           "better": "higher", "source": "host_clock",
                           "layer": "serving/engine.py: Engine.run",
                           "moves": "serve_ttft_p95_ms",
                           "workloads": ["tiny.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = cell.load("tiny.chat", tmp_path)
    ctx = cell.Ctx(spec, 77, 1.0, True, torch.device("cpu"), 0.0)
    out = cell.result(ctx, cell.run(ctx))
    assert out["correct"], out["checks"]
    assert out["metrics"]["batches.tiny"]["value"] >= 1
    ctx = ctx._replace(trace=False)
    out = cell.result(ctx, cell.run(ctx))
    assert set(out["metrics"]) == {"serve_ttft_p95_ms", "setup_s"}
    assert all(p.read_bytes() == v for p, v in before.items())


@pytest.mark.parametrize("name", ["chat_prefix", "unique_docs"])
def test_serving_mix_is_deterministic_in_the_seed(name):
    mix = json.load(open(BENCH / "mixes" / f"{name}.json"))
    a = traffic.serve_requests(mix, 152064, 2 ** 33 + 5, 45.0)
    b = traffic.serve_requests(mix, 152064, 2 ** 33 + 5, 45.0)
    c = traffic.serve_requests(mix, 152064, 2 ** 33 + 6, 45.0)
    assert [r.arrival for r in a] == [r.arrival for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert not all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    # another seed: other data, the same work and the same schedule
    assert len(a) == len(c)
    assert {len(r.prompt) for r in a + c} == {mix["prompt_tokens"]}
    assert [r.arrival for r in a] == [r.arrival for r in c]
    count = lambda rs: sorted(np.bincount([r.system + 1 for r in rs]))
    assert count(a) == count(c)
    assert max(r.arrival for r in a) < 45.0


def test_chat_prefix_shares_about_half_of_its_pages():
    mix = json.load(open(BENCH / "mixes" / "chat_prefix.json"))
    reqs = traffic.serve_requests(mix, 152064, 12345, 45.0)
    page = 16
    seen, repeated, total = set(), 0, 0
    for r in reqs:
        for p in range(len(r.prompt) // page):
            key = r.prompt[:(p + 1) * page].tobytes()
            repeated += key in seen
            seen.add(key)
            total += 1
    assert 0.40 < repeated / total < 0.5
    docs = json.load(open(BENCH / "mixes" / "unique_docs.json"))
    keys = [r.prompt[:16].tobytes()
            for r in traffic.serve_requests(docs, 102400, 12345, 45.0)]
    assert len(set(keys)) == len(keys)


def test_training_batches_are_deterministic_in_the_seed():
    mix = json.load(open(BENCH / "mixes" / "train_4k.json"))
    cpu = torch.device("cpu")
    a = traffic.train_batch(mix, 152064, 2 ** 40, 3, cpu)
    b = traffic.train_batch(mix, 152064, 2 ** 40, 3, cpu)
    c = traffic.train_batch(mix, 152064, 2 ** 40, 4, cpu)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert a["tokens"].shape == (1, 4096)
    assert a["positions"].shape == (3, 1, 4096)


class _Round:
    def __init__(self, tokens):
        self.out = [[0] * tokens]
        self.logits = object()


@pytest.mark.parametrize("need", [1, 10, 25])
def test_sample_keeps_the_seeds_lowest_batches_and_drops_the_rest(need):
    """Batches offered as they are served leave the same sample as the
    seed's priorities over all of them, and the others keep no logits."""
    from pbcore import check
    seed, sizes = 2 ** 33 + 7, [4, 9, 2, 7, 5, 3, 8, 6, 1, 4, 6, 2]
    sample, rounds = check.Sample(seed, need), []
    for k, n in enumerate(sizes):
        r = _Round(n)
        if sample.wants(k):
            sample.offer(k, r)
        else:
            r.logits = None
        rounds.append(r)
    order = sorted(range(len(sizes)), key=sample._priority)
    want, got = set(), 0
    for k in order:
        if got >= need:
            break
        want.add(k)
        got += sizes[k]
    kept = {k for k, r in enumerate(rounds) if r.logits is not None}
    assert kept == want
    assert check.Sample(seed + 1, need)._priority(0) != sample._priority(0)
