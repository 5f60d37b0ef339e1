"""The serving page pool: the reference's ``repro.serving.paged_kv``
(Pallas kernels in interpret mode on the CPU) against the port's
``repro_torch.serving.paged_kv`` (``device="cpu"``, the kernels' plain
versions), replaying the same key streams.

After every batch the gather plans, the integer ``PoolStats``, the
payloads read back and every state array must be identical; ``time_ns``
within 1e-3 relative (both packages add the same Python floats in the
same order, so it is equal in practice).  The streams hold the
reference behaviours the port keeps on purpose: duplicate keys within a
batch, tag-0 keys (below ``total_sets``) and more than 4 requests to one
conventional set in a batch.  Batches of 32 keys keep every kernel call
to a size the reference's tiling accepts.
"""
import jax  # noqa: F401  (both packages in one process, data as numpy)
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import paged_kv as j_kv  # noqa: E402
from repro_torch.core.engine import BackendError  # noqa: E402
from repro_torch.kernels import pool as t_pool  # noqa: E402
from repro_torch.serving import paged_kv as t_kv  # noqa: E402
from torch_parity import pool_payload, pool_stream  # noqa: E402

ENGINE_POOL = dict(conv_sets=64, ext_sets_per_chip=32, ways=4)


def _pair(**kw):
    return (j_kv.MorpheusPagePool(j_kv.PoolConfig(**kw)),
            t_kv.MorpheusPagePool(t_kv.PoolConfig(**kw), device="cpu"))


def _stream(cfg, n_batches=3, seed=0):
    return pool_stream(cfg.amap.total_sets, cfg.conv_sets, n_batches, seed)


def _assert_same_state(ref, port, ctx):
    st = t_kv.pool_to_numpy(port)
    for name in t_kv.STATE_FIELDS:
        a = np.asarray(getattr(ref, name))
        assert a.dtype == st[name].dtype, (ctx, name, a.dtype)
        np.testing.assert_array_equal(a, st[name], err_msg=f"{ctx} {name}")


def _assert_same_stats(ref, port, ctx):
    r, p = ref.stats, port.stats
    assert r[:6] == p[:6], (ctx, r, p)
    for a, b in zip(r[6:], p[6:]):
        assert abs(a - b) <= 1e-3 * max(abs(a), 1.0), (ctx, r, p)


def _replay_batch(ref, port, keys, ctx):
    """One batch on both pools: lookup, install a payload for every
    backing fetch, read the plan back; everything compared."""
    pr, pp = ref.lookup_batch(keys), port.lookup_batch(keys)
    for f, a, b in zip(j_kv.GatherPlan._fields, pr, pp):
        assert a.dtype == b.dtype, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} plan.{f}")
    for k in keys[pr.tier == 2]:
        pay = pool_payload(int(k), ref.cfg.page_words)
        ref.write_page(int(k), jnp.asarray(pay))
        port.write_page(int(k), pay)
    got_r = np.asarray(ref.read_pages(pr))
    got_p = port.read_pages(pp).numpy().view(np.uint32)
    np.testing.assert_array_equal(got_r, got_p, err_msg=f"{ctx} reads")
    _assert_same_stats(ref, port, ctx)
    _assert_same_state(ref, port, ctx)
    return pr


CASES = ([(f"engine/{p}/comp={int(c)}",
           dict(ENGINE_POOL, predictor=p, compression=c))
          for p in ("bloom", "none", "perfect") for c in (True, False)]
         + [("defaults", {}),
            ("no-cache-chips", dict(conv_sets=64, ways=4,
                                    num_cache_chips=0))])


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_pool_replays_identically(name, kw):
    ref, port = _pair(**kw)
    rec_r, rec_p = ref.attach_recorder(), port.attach_recorder()
    tiers = []
    for b, keys in enumerate(_stream(ref.cfg, seed=len(name))):
        tiers.append(_replay_batch(ref, port, keys, f"{name} batch {b}").tier)
    tiers = np.concatenate(tiers)
    assert (tiers == 2).any() and (tiers == 0).any()
    if kw.get("num_cache_chips", 4) and kw.get("predictor") != "none":
        assert (tiers == 1).any(), "the extended tier never hit"
    for a, b in zip(rec_r.arrays(), rec_p.arrays()):
        np.testing.assert_array_equal(a, b)
    assert rec_r.counts() == rec_p.counts() and rec_r.total == rec_p.total
    assert ref.telemetry() == port.telemetry()
    for a, b in zip(ref.resident_keys(), port.resident_keys()):
        np.testing.assert_array_equal(a, b)


def test_reference_behaviours_the_port_keeps():
    """The tag-0 side effect, the drop after 4 conventional rounds and
    duplicate extended-tier fills, each seen on both pools."""
    ref, port = _pair(**ENGINE_POOL)
    total = ref.cfg.amap.total_sets
    # a resident tag-0 page (key 3 < total_sets) has its LRU rewritten
    # by a batch that never asks for it
    _replay_batch(ref, port, np.asarray([3], np.uint32), "tag-0 install")
    _replay_batch(ref, port, np.asarray([3 + total], np.uint32), "tag 1")
    before = t_kv.pool_to_numpy(port)["conv_lru"][3].copy()
    _replay_batch(ref, port, np.asarray([5 + total], np.uint32), "tag-0")
    after = t_kv.pool_to_numpy(port)["conv_lru"][3]
    assert list(before[:2]) == [0xFFF, 0xFFF] and list(after[:2]) == [
        0xFFF, 0xFFE]
    # six requests to conventional set 9: the 5th and 6th get tier 2 and
    # are counted nowhere
    keys = np.asarray([9 + j * total for j in range(1, 7)], np.uint32)
    lookups = port.stats.lookups
    plan = _replay_batch(ref, port, keys, "five rounds")
    assert port.stats.lookups == lookups + 4
    assert (plan.tier[4:] == 2).all()
    # a key repeated in one batch fills two ways of its extended set
    k = next(k for k in range(total, 10 * total)
             if k % total >= ref.cfg.conv_sets)
    _replay_batch(ref, port, np.asarray([k, k], np.uint32), "duplicate")
    s = k % total - ref.cfg.conv_sets
    st = t_kv.pool_to_numpy(port)
    assert (st["ext_valid"][s] & (st["ext_tags"][s] == k // total)).sum() == 2
    # bf1's insert mask went into both filters of the set
    assert st["bf1"][s].any() and (st["bf1"][s] == st["bf2"][s]).all()


def test_a_batch_of_extended_keys_is_recorded_in_one_run():
    """One ``lookup_batch`` of K extended keys (repeated sets, one key
    twice) runs the predictor's query once and ``bloom_record`` once,
    where the reference's per-key record made 2K + 1 queries; the filters
    and MRU counts stay the reference's."""
    ref, port = _pair(**dict(ENGINE_POOL, ways=2))
    total, conv = ref.cfg.amap.total_sets, ref.cfg.conv_sets
    sets = [conv + s for s in (5, 9, 5, 70, 9, 5, 5, 9)]
    keys = np.asarray([s + total * (3 + j) for j, s in enumerate(sets)]
                      + [sets[0] + total * 3], np.uint32)
    for b in range(3):
        t_pool.reset_launches()
        plan = port.lookup_batch(keys)
        assert (plan.tier != 0).all()
        assert t_pool.plain_runs["bloom_query"] == 1
        assert t_pool.plain_runs["bloom_record"] == 1
        assert t_pool.plain_runs["read_rows"] == 0
        ref.lookup_batch(keys)
        _assert_same_state(ref, port, f"batch {b}")
        _assert_same_stats(ref, port, f"batch {b}")
    assert t_kv.pool_to_numpy(port)["n_mru"].any()


def _count_reads(monkeypatch) -> dict:
    """Count the pool's reads of device tensors back to the host."""
    reads = {"_host": 0, "_host_u32": 0}
    for name in reads:
        def read(t, name=name, fn=getattr(t_kv, name)):
            reads[name] += 1
            return fn(t)
        monkeypatch.setattr(t_kv, name, read)
    return reads


@pytest.mark.parametrize("rounds", [1, 2, 4, 6])
def test_a_batch_of_conventional_keys_is_one_lookup_fill(rounds,
                                                         monkeypatch):
    """One ``lookup_batch`` whose conventional keys need ``rounds`` rounds
    (six keys to one set: four run, two get tier 2) makes one
    ``lookup_fill`` and reads the card back once (``_host``), where the
    reference ran a ``tag_lookup`` and two reads a round and two more a
    fill; plans, stats, recorder events and state stay the reference's."""
    ref, port = _pair(**ENGINE_POOL)
    rec_r, rec_p = ref.attach_recorder(), port.attach_recorder()
    total = ref.cfg.amap.total_sets
    for b in range(3):                               # fills, then evictions
        keys = np.asarray([s + total * (b * 7 + j) for j in range(rounds)
                           for s in (3, 17, 40)] + [50 + total * (b + 1)],
                          np.uint32)
        t_pool.reset_launches()
        with monkeypatch.context() as m:
            reads = _count_reads(m)
            plan = port.lookup_batch(keys)
        assert t_pool.plain_runs["lookup_fill"] == 1
        assert t_pool.plain_runs["tag_lookup"] == 0
        assert reads == {"_host": 1, "_host_u32": 0}
        np.testing.assert_array_equal(plan.tier, ref.lookup_batch(keys).tier)
        _assert_same_state(ref, port, f"batch {b}")
        _assert_same_stats(ref, port, f"batch {b}")
    assert (plan.tier[3 * 4:-1] == 2).all()          # past the 4th round
    for a, b in zip(rec_r.arrays(), rec_p.arrays()):
        np.testing.assert_array_equal(a, b)
    assert rec_p.counts()["insert"] and (rounds == 1
                                         or rec_p.counts()["evict"])


def test_write_page_is_one_page_write_and_no_read_back(monkeypatch):
    port = t_kv.MorpheusPagePool(t_kv.PoolConfig(**ENGINE_POOL),
                                 device="cpu")
    total = port.cfg.amap.total_sets
    keys = np.asarray([total * 2 + s for s in (3, 70, 100)], np.uint32)
    port.lookup_batch(keys)
    reads = _count_reads(monkeypatch)
    for k in list(keys) + [total * 9 + 3]:           # the last one misses
        t_pool.reset_launches()
        port.write_page(int(k), pool_payload(int(k)))
        assert {n: v for n, v in t_pool.plain_runs.items() if v} == {
            "page_write": 1}
    assert reads == {"_host": 0, "_host_u32": 0}
    plan = port.lookup_batch(keys)
    assert set(plan.tier) == {0, 1}
    np.testing.assert_array_equal(
        port.read_pages(plan).numpy().view(np.uint32),
        [pool_payload(int(k)) for k in keys])


def test_read_pages_is_one_read_of_both_tiers():
    port = t_kv.MorpheusPagePool(t_kv.PoolConfig(**ENGINE_POOL),
                                 device="cpu")
    total = port.cfg.amap.total_sets
    keys = np.asarray([total * 2 + s for s in range(0, total, 3)], np.uint32)
    port.lookup_batch(keys)
    for k in keys:
        port.write_page(int(k), pool_payload(int(k)))
    plan = port.lookup_batch(keys)
    assert set(plan.tier) == {0, 1}
    t_pool.reset_launches()
    port.read_pages(plan)
    assert {k: v for k, v in t_pool.plain_runs.items() if v} == {
        "read_rows": 1}


def test_written_payloads_read_back_at_every_level():
    """No eviction pressure: every hit reads back the payload written at
    its fetch, on both tiers, for HIGH, LOW and UNCOMP blocks."""
    port = t_kv.MorpheusPagePool(t_kv.PoolConfig(**ENGINE_POOL),
                                 device="cpu")
    total = port.cfg.amap.total_sets
    keys = np.asarray([total * 3 + s for s in range(0, total, 7)],
                      np.uint32)
    plan = port.lookup_batch(keys)
    assert (plan.tier == 2).all()
    for k in keys:
        port.write_page(int(k), pool_payload(int(k)))
    plan = port.lookup_batch(keys)
    assert set(plan.tier) == {0, 1}
    got = port.read_pages(plan).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, [pool_payload(int(k)) for k in keys])
    levels = t_kv.pool_to_numpy(port)["ext_level"][
        plan.set_idx[plan.tier == 1], plan.way[plan.tier == 1]]
    assert set(levels) == {0, 1, 2}


def test_reconfigure_flushes_identically():
    ref, port = _pair(**ENGINE_POOL)
    for b, keys in enumerate(_stream(ref.cfg, n_batches=2, seed=7)):
        _replay_batch(ref, port, keys, f"before {b}")
    flushed = ref.reconfigure(2)
    assert port.reconfigure(2) == flushed > 0
    assert port.cfg == t_kv.PoolConfig(**dict(ENGINE_POOL,
                                              num_cache_chips=2))
    assert port.reconfigure(2) == 0
    for b, keys in enumerate(_stream(ref.cfg, n_batches=1, seed=8)):
        _replay_batch(ref, port, keys, f"after {b}")


def test_warm_reference_pool_carries_over():
    """A reference pool's state, carried over with ``pool_from_numpy``,
    replays the next batches identically; ``pool_to_numpy`` round-trips
    the port's own state."""
    kw = dict(ENGINE_POOL, compression=True)
    ref = j_kv.MorpheusPagePool(j_kv.PoolConfig(**kw))
    port_cold = t_kv.MorpheusPagePool(t_kv.PoolConfig(**kw), device="cpu")
    batches = list(_stream(ref.cfg, n_batches=4, seed=11))
    for b, keys in enumerate(batches[:2]):
        _replay_batch(ref, port_cold, keys, f"warm-up {b}")
    arrays = {name: np.asarray(getattr(ref, name))
              for name in t_kv.STATE_FIELDS}
    arrays["stats"] = ref.stats
    port = t_kv.pool_from_numpy(t_kv.PoolConfig(**kw), arrays, device="cpu")
    _assert_same_state(ref, port, "carried")
    for b, keys in enumerate(batches[2:]):
        _replay_batch(ref, port, keys, f"after carry {b}")
    again = t_kv.pool_from_numpy(port.cfg, t_kv.pool_to_numpy(port), "cpu")
    _assert_same_state(ref, again, "round trip")
    with pytest.raises(ValueError, match="conv_tags"):
        t_kv.pool_from_numpy(t_kv.PoolConfig(), arrays, device="cpu")


def test_pool_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(BackendError, match="device='cpu'"):
        t_kv.MorpheusPagePool(t_kv.PoolConfig())


def test_page_key_and_helpers_match_the_reference():
    for args in [(0, 0, 0), (123456789, 35, 15), (2**63, 7, 2**40)]:
        assert t_kv.page_key(*args) == j_kv.page_key(*args)
    # the conventional tier's accounting order is the reference's: rounds
    # of _first_per_set over the batch, at most 4
    req_set = np.asarray([4, 1, 4, 4, 2, 1, 4, 4, 4], np.int32)
    rank = t_pool._ranks(req_set.astype(np.int64))
    got = t_kv._round_order(np.where(rank < t_pool.ROUNDS, rank, -1))
    idx, want = np.arange(len(req_set)), []
    for _ in range(4):
        first = j_kv._first_per_set(req_set)
        want += list(idx[first])
        req_set, idx = j_kv._drop_first(req_set, idx, first)
    np.testing.assert_array_equal(got, want)
    assert len(want) == 7 and req_set.size == 2   # set 4's 5th and 6th
