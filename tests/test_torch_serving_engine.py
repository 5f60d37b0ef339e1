"""The port's serving engine (``repro_torch.serving.Engine`` on the CPU)
against the reference's (``repro.serving.engine.Engine``) on the reduced
qwen3-4b with the same weights (``seeded_numpy_params``), on the cases of
tests/test_serving.py: batch serving, prefix reuse, a shared prefix with
a diverging suffix, order sensitivity, and Morpheus on and off.

Held after every ``run``: the generated tokens and the integer
``EngineReport`` and ``PoolStats`` fields identical, ``modeled_time_ns``
and ``PoolStats.time_ns`` within 1e-3 relative (the same modeled tier
costs summed in the same order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.engine import BackendError  # noqa: E402
from repro_torch.models import LM, seeded_numpy_params  # noqa: E402
from repro_torch.serving import Engine, Request, sampler  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    tc = t_configs.get("qwen3-4b").reduced()
    return seeded_numpy_params(tc, 0)


def engines(weights, **kw):
    """(reference, port) engines on the same weights."""
    jc = j_configs.get("qwen3-4b").reduced()
    tc = t_configs.get("qwen3-4b").reduced()
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    return (JEngine(JLM(jc), jp, max_len=64, **kw),
            Engine(LM(tc, device="cpu"), weights, max_len=64, **kw))


def run_both(pair, prompts, new_tokens):
    """Serve the same requests on both engines and hold every field."""
    j_eng, t_eng = pair
    jr = [JRequest(i, p, new_tokens) for i, p in enumerate(prompts)]
    tr = [Request(i, p, new_tokens) for i, p in enumerate(prompts)]
    j_rep, t_rep = j_eng.run(jr), t_eng.run(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    a, b = dataclasses.asdict(j_rep), dataclasses.asdict(t_rep)
    assert abs(a.pop("modeled_time_ns") - b.pop("modeled_time_ns")) <= \
        1e-3 * max(abs(j_rep.modeled_time_ns), 1.0)
    assert a == b
    js, ts = j_eng.pool.stats._asdict(), t_eng.pool.stats._asdict()
    assert abs(js.pop("time_ns") - ts.pop("time_ns")) <= \
        1e-3 * max(abs(j_eng.pool.stats.time_ns), 1.0)
    assert {k: int(v) for k, v in js.items()} == ts
    return t_rep, tr


def test_engine_serves_batch(weights):
    rep, reqs = run_both(engines(weights), [list(range(1, 33))] * 2, 4)
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert rep.generated == 8 and rep.steps == 3


def test_engine_prefix_cache_reuse(weights):
    pair = engines(weights)
    prompt = list(range(1, 33))
    r1, _ = run_both(pair, [prompt], 2)
    assert r1.pages_reused == 0 and r1.pages_fetched == 2
    r2, _ = run_both(pair, [prompt], 2)
    assert r2.pages_reused >= 2


def test_engine_shared_prefix_diverging_suffix(weights):
    pair = engines(weights)
    base = list(range(1, 33))
    run_both(pair, [base], 2)
    run_both(pair, [base[:24] + [88] * 8], 2)
    assert pair[1].pages_reused == 1 and pair[1].pages_fetched == 3
    run_both(pair, [[97] + base[1:]], 2)
    assert pair[1].pages_reused == 1 and pair[1].pages_fetched == 5


def test_engine_prefix_hash_order_sensitivity(weights):
    pair = engines(weights)
    p1 = list(range(1, 33))
    p2 = p1[:]
    p2[0], p2[1] = p2[1], p2[0]
    run_both(pair, [p1], 2)
    run_both(pair, [p2], 2)
    assert pair[1].pages_reused == 0 and pair[1].pages_fetched == 4


@pytest.mark.parametrize("morpheus", [True, False])
def test_engine_morpheus_on_and_off(weights, morpheus):
    """Each setting equals the reference's; the tokens do not depend on
    it (the pool only moves where pages live)."""
    prompt = list(range(5, 25))
    _, reqs = run_both(engines(weights, morpheus=morpheus), [prompt], 6)
    port_other = Engine(LM(t_configs.get("qwen3-4b").reduced(),
                           device="cpu"), weights, max_len=64,
                        morpheus=not morpheus)
    other = [Request(0, prompt, 6)]
    port_other.run(other)
    assert other[0].out_tokens == reqs[0].out_tokens


def test_engine_runs_the_full_prefill_whatever_the_pool_says(weights):
    """As in the reference, the pool only accounts for hits: a second run
    of the same prompt hits every page and still gives the same tokens
    from a full prefill."""
    pair = engines(weights)
    prompt = list(range(3, 35))
    _, first = run_both(pair, [prompt, prompt[::-1]], 5)
    rep, again = run_both(pair, [prompt, prompt[::-1]], 5)
    assert rep.pages_reused == 4
    assert [r.out_tokens for r in again] == [r.out_tokens for r in first]


def test_engine_page_payload_matches_the_reference_digest():
    prefix = list(range(16))
    raw = bytes(prefix.__repr__(), "utf8")
    import hashlib
    want = np.frombuffer(
        hashlib.blake2b(raw, digest_size=64, salt=b"pg0").digest()
        + hashlib.blake2b(raw, digest_size=64, salt=b"pg1").digest(),
        np.uint32)
    np.testing.assert_array_equal(t_engine.page_payload(prefix), want)


def test_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(BackendError):
        Engine(LM(t_configs.get("qwen3-4b").reduced()))


# ----------------------------------------------------------------- sampler

def test_sampler_greedy_and_temperature_zero():
    logits = torch.tensor([[0.1, 3.0, 3.0, -1.0], [5.0, 0.0, 1.0, 2.0]])
    assert sampler.greedy(logits).tolist() == [1, 0]       # first on ties
    assert sampler.greedy(logits).dtype == torch.int32
    g = torch.Generator().manual_seed(0)
    assert torch.equal(sampler.sample(g, logits, temperature=0.0),
                       sampler.greedy(logits))


def test_sampler_top_k_support_and_distribution():
    """``jax.random`` bits cannot be reproduced: the test holds the top-k
    support and the sampled frequencies to softmax(logits / T)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    g = torch.Generator().manual_seed(1)
    draws = sampler.sample(g, logits.expand(20000, 6), temperature=0.7,
                           top_k=3)
    assert set(draws.tolist()) <= {0, 1, 2}
    want = torch.softmax(logits[:3] / 0.7, dim=0).numpy()
    got = np.bincount(draws.numpy(), minlength=6)[:3] / len(draws)
    np.testing.assert_allclose(got, want, atol=0.015)
    full = sampler.sample(g, logits.expand(20000, 6), temperature=1.0)
    got = np.bincount(full.numpy(), minlength=6) / len(full)
    np.testing.assert_allclose(got, torch.softmax(logits, 0).numpy(),
                               atol=0.015)
