"""The readings of the program's own spans (``pbcore/spans.py``) on
hand-made spans, each with its value and None where the spans are absent;
the records of the program's tracer; and ``spans.py`` rehearsed on the
CPU at a tiny width."""
import json

import pytest

from conftest import tiny_ctx
from pbcore import spans as S

MS = 1_000_000
SERVING = {"moe_dispatch_ms", "decode_step_ms", "expert_segments_per_step",
           "readbacks_per_step", "pool_readbacks_per_batch"}


def _span(i, name, parent, t0, t1, device_ms=None, **tags):
    return {"name": name, "t0": t0 * MS, "t1": t1 * MS, "id": i,
            "parent": parent, "tags": tags, "device_ms": device_ms}


def _served():
    """One batch: a consultation of one key (two reads of the pool), a
    decode iteration that ran a step with one MoE layer, and the last
    iteration, which only reads."""
    return [
        _span(4, "pool.readback", 3, 1, 2), _span(5, "pool.readback", 3, 2, 3),
        _span(3, "pool.lookup", 2, 1, 4, keys=1, tier=1),
        _span(6, "pool.write", 2, 4, 5, keys=1, tier=1),
        _span(2, "serve.consult", 1, 0, 6, keys=1),
        _span(8, "serve.readback", 7, 10, 11, bytes=4),
        _span(12, "moe.readback", 11, 14, 15, bytes=520),
        _span(13, "moe.experts", 11, 15, 19, segments=5),
        _span(11, "moe.dispatch", 10, 13, 20, tokens=1),
        _span(10, "decode.mlp", 9, 13, 20, layer=1),
        _span(9, "lm.decode_step", 7, 12, 21),
        _span(7, "serve.decode_step", 1, 10, 22, t=0),
        _span(15, "serve.readback", 14, 23, 24, bytes=4),
        _span(14, "serve.decode_step", 1, 23, 25, t=1),
        _span(1, "serve.batch", None, 0, 26, batch=1),
    ]


def _trained(edges=True):
    ms = (3.0, 5.0, 1.0, 9.2) if edges else (None,) * 4
    return [_span(21, "train.forward", 20, 1, 2, ms[0]),
            _span(22, "train.backward", 20, 2, 4, ms[1]),
            _span(23, "train.optimizer", 20, 4, 5, ms[2]),
            _span(20, "train.step", None, 0, 6, ms[3], tokens=4096)]


def test_serving_readings():
    sp = _served()
    assert S.moe_dispatch_ms(sp) == 7.0
    assert S.decode_step_ms(sp) == 9.0
    assert S.expert_segments_per_step(sp) == 5
    assert S.readbacks_per_step(sp) == 2.0       # the sampler's and MoE's
    assert S.pool_readbacks_per_batch(sp) == 2.0
    assert S.readings(sp) == {"moe_dispatch_ms": 7.0,
                              "decode_step_ms": 9.0,
                              "expert_segments_per_step": 5.0,
                              "readbacks_per_step": 2.0,
                              "pool_readbacks_per_batch": 2.0}


def test_training_readings():
    sp = _trained()
    assert S.phase_ms(sp, "train.forward") == 3.0
    assert S.phase_ms(sp, "train.backward") == 5.0
    assert S.phase_ms(sp, "train.optimizer") == 1.0
    assert S.step_device_ms(sp) == 9.2
    assert set(S.readings(sp)) == {"forward_ms", "backward_ms",
                                   "optimizer_ms", "step_device_ms"}
    # without device edges (a CPU run) there is nothing to read
    assert S.readings(_trained(edges=False)) == {}


@pytest.mark.parametrize("name", sorted(S.READINGS))
def test_each_reading_is_none_where_the_spans_are_absent(name):
    assert S.READINGS[name]([]) is None
    # a dense model's step: no MoE layer, one read a step
    dense = [s for s in _served() if not s["name"].startswith("moe.")]
    want = {"readbacks_per_step": 1.0, "pool_readbacks_per_batch": 2.0,
            "decode_step_ms": 9.0}
    assert S.READINGS[name](dense) == want.get(name)
    # a serving reading of a training cell's spans, and the reverse
    other = _trained() if name in SERVING else _served()
    assert S.READINGS[name](other) is None


def test_self_ms_takes_the_children_out():
    got = S.self_ms(_served())
    assert got["serve.batch"] == 26 - 6 - 12 - 2
    assert got["moe.dispatch"] == 7 - 1 - 4
    assert got["pool.readback"] == 2


def test_collect_reads_the_program_tracer():
    from repro_torch import obs
    ticks = iter(range(0, 10 ** 6, 1000))
    t = obs.Tracer(clock=lambda: next(ticks))
    with t.span("serve.batch", batch=1):
        with t.span("serve.consult", keys=2):
            pass
    got = S.collect(t)
    assert [(s["name"], s["t0"], s["t1"], s["parent"]) for s in got] == [
        ("serve.consult", 1000, 2000, 1), ("serve.batch", 0, 3000, None)]
    assert got[0]["device_ms"] is None and got[0]["tags"] == {"keys": 2}
    assert S.intervals(got) == [("serve.consult", 1000, 2000),
                                ("serve.batch", 0, 3000)]
    # a program whose tracer keeps no records, or tracing off
    assert S.collect(object()) == [] and S.collect(None) == []


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_spans_tool_rehearses_a_serving_cell(capsys):
    import spans
    ctx = tiny_ctx("dsmoe16b.unique_docs", trace=True, seconds=0.5)
    spans.serve_cell(ctx, turns=2, pairs=1)
    *wins, pair, last = _lines(capsys)
    assert len(pair["off_s"]) == len(pair["on_s"]) == 1
    assert [(w["window"], w["tracing"]) for w in wins] == [(0, False),
                                                           (1, True)]
    assert wins[0]["program_spans"] == 0 < wins[1]["program_spans"]
    assert all(w["serve_tokens_per_s"] > 0 for w in wins)
    moe_layers = ctx.config["num_layers"] - ctx.config["first_dense_layers"]
    r = last["readings"]
    assert r["readbacks_per_step"] == moe_layers + 1
    assert r["expert_segments_per_step"] > 0 and r["moe_dispatch_ms"] > 0
    assert r["pool_readbacks_per_batch"] > 0
    assert last["spans"]["serve.batch"] == 2
    assert "busy_s" not in last                 # no device trace here


def test_spans_tool_rehearses_a_training_cell(capsys):
    import spans
    ctx = tiny_ctx("qwen2vl7b.train_4k", trace=True, seconds=0.3)
    spans.train_cell(ctx, turns=1, pairs=2)
    win, pair, last = _lines(capsys)
    assert len(pair["off_s"]) == len(pair["on_s"]) == 2
    assert win["tracing"] is False and win["train_tokens_per_s"] > 0
    assert last["spans"]["train.step"] == 2
    assert last["readings"] == {}      # device edges only on a card
