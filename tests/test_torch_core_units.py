"""The port's core pieces that no path calls (``repro_torch.core``:
``tag_store``, ``compression``, ``extended_cache`` and the Bloom
predictor and counting filter of ``bloom``) against the reference's
(``repro.core``), on the cases of tests/test_core_units.py and
tests/test_bloom.py run through both packages on the same inputs.

Every result is held identical: hits, ways, evicted tags, levels,
payloads, byte counts, filter words, counters and statistics; the
compression ratio within 1e-6 (the same f32 mean).  Each port call must
leave its input state untouched, as the reference's functional calls
do."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package "
    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import bloom as j_bloom  # noqa: E402
from repro.core import compression as j_bdi  # noqa: E402
from repro.core import extended_cache as j_ec  # noqa: E402
from repro.core import tag_store as j_ts  # noqa: E402
from repro_torch import _u32  # noqa: E402
from repro_torch.core import bloom as t_bloom  # noqa: E402
from repro_torch.core import compression as t_bdi  # noqa: E402
from repro_torch.core import extended_cache as t_ec  # noqa: E402
from repro_torch.core import tag_store as t_ts  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402


def u32(x) -> np.ndarray:
    """uint32 values of a port tensor (int32 bit patterns) or a
    reference array."""
    if isinstance(x, torch.Tensor):
        return _u32.to_u(x).numpy() if x.dtype == torch.int32 \
            else x.numpy()
    return np.asarray(x).astype(np.int64)


def same_state(ref, port):
    """Every field of two NamedTuple states equal, as uint32 values for
    the tensors the port keeps as bit patterns."""
    assert ref._fields == port._fields
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f)
        else:
            np.testing.assert_array_equal(a.astype(np.int64), u32(b),
                                          err_msg=f)


def frozen(state):
    return tuple(t.clone() for t in state)


def untouched(before, state):
    assert all(torch.equal(a, b) for a, b in zip(before, state))


# ---------------------------------------------------------------- tag store

def tag_store_pair(num_sets, ways):
    return (j_ts.make_state(num_sets, ways),
            t_ts.make_state(num_sets, ways, device="cpu"))


def test_tag_store_miss_then_hit():
    js, ts = tag_store_pair(4, 4)
    jr, tr = j_ts.lookup(js, jnp.int32(1), jnp.uint32(42)), \
        t_ts.lookup(ts, 1, 42)
    assert not bool(tr.hit) and bool(tr.hit) == bool(jr.hit)
    js, jins = j_ts.insert(js, jnp.int32(1), jnp.uint32(42))
    before = frozen(ts)
    ts, tins = t_ts.insert(ts, 1, 42)
    untouched(before, t_ts.make_state(4, 4, device="cpu"))
    assert not bool(tins.evicted_valid)
    assert int(tins.way) == int(jins.way)
    same_state(js, ts)
    tr = t_ts.lookup(ts, 1, 42)
    assert bool(tr.hit) and int(tr.way) == int(tins.way)


def test_tag_store_lru_eviction_order():
    ways = 4
    js, ts = tag_store_pair(1, ways)
    for t in range(ways):
        js, _ = j_ts.insert(js, jnp.int32(0), jnp.uint32(t))
        ts, _ = t_ts.insert(ts, 0, t)
    js = j_ts.touch(js, jnp.int32(0), j_ts.lookup(js, jnp.int32(0),
                                                  jnp.uint32(0)).way)
    before = frozen(ts)
    ts2 = t_ts.touch(ts, 0, t_ts.lookup(ts, 0, 0).way)
    untouched(before, ts)
    same_state(js, ts2)
    assert int(t_ts.victim(ts2, 0)) == int(j_ts.victim(js, jnp.int32(0)))
    js, jins = j_ts.insert(js, jnp.int32(0), jnp.uint32(99))
    ts2, tins = t_ts.insert(ts2, 0, 99)
    assert bool(tins.evicted_valid)
    assert int(u32(tins.evicted_tag)) == int(jins.evicted_tag) == 1
    same_state(js, ts2)
    assert float(t_ts.occupancy(ts2)) == float(j_ts.occupancy(js))


def test_tag_store_dirty_writeback_flag():
    js, ts = tag_store_pair(1, 1)
    js, _ = j_ts.insert(js, jnp.int32(0), jnp.uint32(7), write=True)
    ts, _ = t_ts.insert(ts, 0, 7, write=True)
    js, jins = j_ts.insert(js, jnp.int32(0), jnp.uint32(8))
    ts, tins = t_ts.insert(ts, 0, 8)
    assert bool(tins.evicted_dirty) and bool(jins.evicted_dirty)
    same_state(js, ts)


def test_tag_store_takes_the_full_uint32_range():
    js, ts = tag_store_pair(2, 2)
    for tag in (0, 2 ** 31, 2 ** 32 - 1):
        js, jins = j_ts.insert(js, jnp.int32(1), jnp.uint32(tag))
        ts, tins = t_ts.insert(ts, 1, tag)
        assert int(u32(tins.evicted_tag)) == int(jins.evicted_tag)
        assert bool(t_ts.lookup(ts, 1, tag).hit)
        same_state(js, ts)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 63), min_size=1, max_size=80),
       st.integers(2, 8))
def test_property_tag_store_matches_the_reference(seq, ways):
    """Both stores, and a Python LRU model, through the same accesses
    (write hits on odd tags)."""
    js, ts = tag_store_pair(1, ways)
    model: list = []
    for t in seq:
        jr, tr = j_ts.lookup(js, jnp.int32(0), jnp.uint32(t)), \
            t_ts.lookup(ts, 0, t)
        assert bool(tr.hit) == bool(jr.hit) == (t in model)
        if t in model:
            assert int(tr.way) == int(jr.way)
            js = j_ts.touch(js, jnp.int32(0), jr.way, write=bool(t % 2))
            ts = t_ts.touch(ts, 0, tr.way, write=bool(t % 2))
            model.remove(t)
        else:
            js, jins = j_ts.insert(js, jnp.int32(0), jnp.uint32(t))
            ts, tins = t_ts.insert(ts, 0, t)
            assert int(tins.way) == int(jins.way)
            assert bool(tins.evicted_dirty) == bool(jins.evicted_dirty)
        model = (model + [t])[-ways:]
    same_state(js, ts)


# ----------------------------------------------------------------- BDI

def bdi_blocks():
    base = np.uint32(1000)
    rng = np.random.default_rng(0)
    return np.stack([
        np.array([base + i for i in range(32)], np.uint32),          # HIGH
        np.array([base + i * 300 for i in range(32)], np.uint32),    # LOW
        rng.integers(0, 2 ** 32, size=32, dtype=np.uint32),          # UNCOMP
        (np.uint32(2 ** 32 - 5) + np.arange(32, dtype=np.uint32)),   # wraps
        np.full(32, 2 ** 31, np.uint32)])


def tblocks(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def test_bdi_levels_and_sizes_match_reference():
    blocks = bdi_blocks()
    jl = np.asarray(j_bdi.classify(jnp.asarray(blocks)))
    tl = t_bdi.classify(tblocks(blocks))
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert tl[:3].tolist() == [t_bdi.HIGH, t_bdi.LOW, t_bdi.UNCOMP]
    np.testing.assert_array_equal(
        t_bdi.physical_bytes(tl).numpy(),
        np.asarray(j_bdi.physical_bytes(jnp.asarray(jl))))
    assert abs(float(t_bdi.compression_ratio(tl))
               - float(j_bdi.compression_ratio(jnp.asarray(jl)))) <= 1e-6


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.integers(-127, 127))
def test_property_bdi_compress_matches_reference(base, delta):
    block = (np.uint64(base) + np.uint64(delta % 97)
             * np.arange(32, dtype=np.uint64)) % np.uint64(2 ** 32)
    blocks = block.astype(np.uint32)[None]
    jc = j_bdi.compress(jnp.asarray(blocks))
    tc = t_bdi.compress(tblocks(blocks))
    assert int(tc.level[0]) == int(jc.level[0])
    np.testing.assert_array_equal(u32(tc.base), u32(jc.base))
    np.testing.assert_array_equal(u32(tc.payload), u32(jc.payload))
    np.testing.assert_array_equal(u32(t_bdi.decompress(tc)),
                                  blocks.astype(np.int64))


def test_bdi_roundtrip_random_blocks():
    rng = np.random.default_rng(1)
    blocks = np.concatenate([rng.integers(0, 2 ** 32, size=(64, 32),
                                          dtype=np.uint32), bdi_blocks()])
    tc = t_bdi.compress(tblocks(blocks))
    jc = j_bdi.compress(jnp.asarray(blocks))
    np.testing.assert_array_equal(tc.level.numpy(), np.asarray(jc.level))
    np.testing.assert_array_equal(u32(tc.payload), u32(jc.payload))
    np.testing.assert_array_equal(u32(t_bdi.decompress(tc)),
                                  blocks.astype(np.int64))


def test_bdi_allocator_adapts_as_the_reference():
    ja = j_bdi.make_allocator(total_bytes=32 * 128, epoch_len=10)
    ta = t_bdi.make_allocator(total_bytes=32 * 128, epoch_len=10)
    assert int(t_bdi.effective_capacity_blocks(ta)) == 32
    levels = [t_bdi.HIGH] * 10 + [t_bdi.LOW, t_bdi.UNCOMP, t_bdi.HIGH] * 7
    for lv in levels:
        ja = j_bdi.allocator_observe(ja, jnp.int32(lv))
        ta = t_bdi.allocator_observe(ta, lv)
        for f in ("counts", "slots", "tick"):
            np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                          np.asarray(getattr(ja, f)))
        assert int(t_bdi.effective_capacity_blocks(ta)) == \
            int(j_bdi.effective_capacity_blocks(ja))
    # after the all-HIGH epoch most slots went to HIGH (capacity ~4x)
    first = t_bdi.make_allocator(total_bytes=32 * 128, epoch_len=10)
    for _ in range(10):
        first = t_bdi.allocator_observe(first, t_bdi.HIGH)
    assert int(t_bdi.effective_capacity_blocks(first)) > 100


# ----------------------------------------------------------- extended cache

def ext_pair(num_sets, ways, compression):
    return (j_ec.make_state(num_sets=num_sets, ways=ways,
                            compression=compression),
            t_ec.make_state(num_sets=num_sets, ways=ways,
                            compression=compression, device="cpu"))


def ext_insert(pair, s, tag, size, budget, write=False):
    js, ts = pair
    js, jr = j_ec.insert(js, jnp.int32(s), jnp.uint32(tag), jnp.int32(size),
                         budget, write=write)
    before = frozen(ts)
    ts2, tr = t_ec.insert(ts, s, tag, size, budget, write=write)
    untouched(before, ts)
    assert (int(tr.way), int(tr.evictions), int(tr.writebacks)) == \
        (int(jr.way), int(jr.evictions), int(jr.writebacks))
    same_state(js, ts2)
    return (js, ts2), tr


def test_ext_cache_compressed_holds_more_blocks():
    ways = 4
    pair = ext_pair(1, ways, True)
    budget = t_ec.set_budget_bytes(ways)
    assert budget == j_ec.set_budget_bytes(ways)
    for t in range(16):
        pair, r = ext_insert(pair, 0, t, 32, budget)
        assert int(r.evictions) == 0
    for t in range(16):
        assert bool(t_ec.lookup(pair[1], 0, t)[0])


def test_ext_cache_uncompressed_evicts_at_ways():
    ways = 4
    pair = ext_pair(1, ways, False)
    budget = t_ec.set_budget_bytes(ways)
    for t in range(ways):
        pair, r = ext_insert(pair, 0, t, 128, budget, write=bool(t % 2))
        assert int(r.evictions) == 0
    pair, r = ext_insert(pair, 0, 99, 128, budget)
    assert int(r.evictions) == 1


def test_ext_cache_big_insert_evicts_several_small():
    pair = ext_pair(1, 1, True)
    budget = t_ec.set_budget_bytes(1)
    for t in range(4):
        pair, _ = ext_insert(pair, 0, t, 32, budget, write=True)
    pair, r = ext_insert(pair, 0, 50, 128, budget)
    assert int(r.evictions) == 4 and int(r.writebacks) == 4
    assert int(pair[1].used.sum()) == 128


@settings(max_examples=15, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 31), st.sampled_from([32, 64, 128])),
                min_size=1, max_size=60))
def test_property_ext_cache_matches_reference(ops):
    ways = 4
    pair = ext_pair(2, ways, True)
    budget = t_ec.set_budget_bytes(ways)
    for tag, size in ops:
        js, ts = pair
        jhit, jway = j_ec.lookup(js, jnp.int32(tag % 2), jnp.uint32(tag))
        thit, tway = t_ec.lookup(ts, tag % 2, tag)
        assert bool(thit) == bool(jhit)
        if bool(thit):
            assert int(tway) == int(jway)
            pair = (j_ec.touch(js, jnp.int32(tag % 2), jway, write=True),
                    t_ec.touch(ts, tag % 2, tway, write=True))
            same_state(*pair)
        else:
            pair, _ = ext_insert(pair, tag % 2, tag, size, budget)
        ts = pair[1]
        assert int(ts.used.max()) <= budget
        np.testing.assert_array_equal(
            torch.where(ts.valid, ts.size, 0).sum(1).numpy(), ts.used.numpy())


def test_capacity_per_cache_chip_matches_reference():
    kw = dict(vmem_budget_bytes=256 * 1024, hbm_budget_bytes=1 << 20)
    assert t_ec.capacity_per_cache_chip(**kw) == \
        j_ec.capacity_per_cache_chip(**kw)


# ------------------------------------------------------ double-Bloom filter

def bloom_pair(num_sets, assoc, **kw):
    return (j_bloom.make_state(num_sets=num_sets, associativity=assoc, **kw),
            t_bloom.make_state(num_sets=num_sets, associativity=assoc,
                               device="cpu", **kw))


def record(pair, s, tag):
    js, ts = pair
    before = frozen(ts)
    out = (j_bloom.record_access(js, jnp.int32(s), jnp.uint32(tag)),
           t_bloom.record_access(ts, s, tag))
    untouched(before, ts)
    same_state(*out)
    return out


def predict(pair, s, tag):
    js, ts = pair
    jh, js = j_bloom.predict(js, jnp.int32(s), jnp.uint32(tag))
    th, ts = t_bloom.predict(ts, s, tag)
    assert bool(th) == bool(jh)
    same_state(js, ts)
    return bool(th), (js, ts)


def test_empty_filter_predicts_miss():
    hit, (_, ts) = predict(bloom_pair(4, 8), 0, 123)
    assert not hit
    assert int(ts.queries) == 1 and int(ts.predicted_hits) == 0


def test_inserted_tag_predicts_hit_in_its_set_only():
    pair = record(bloom_pair(4, 8), 2, 77)
    assert predict(pair, 2, 77)[0]
    assert not predict(pair, 1, 77)[0]


def test_swap_happens_at_associativity_and_keeps_the_mru():
    assoc = 4
    pair = bloom_pair(1, assoc)
    tags = [10, 20, 30, 40]
    for t in tags:
        pair = record(pair, 0, t)
    assert int(pair[1].swaps) == 1 and int(pair[1].n_mru[0]) == 0
    for t in tags:
        hit, pair = predict(pair, 0, t)
        assert hit, f"false negative for tag {t} after the swap"


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=2 ** 32 - 1), min_size=1,
                max_size=64),
       st.integers(min_value=2, max_value=16))
def test_property_no_false_negatives_and_same_state(tags, assoc):
    """The paper's invariant on the port, with every state equal to the
    reference's: each tag resident in an LRU model is predicted hit."""
    pair = bloom_pair(1, assoc)
    resident: list = []
    for t in tags:
        if t in resident:
            resident.remove(t)
        resident = (resident + [t])[-assoc:]
        pair = record(pair, 0, t)
        for r in resident:
            hit, pair = predict(pair, 0, r)
            assert hit, f"false negative: resident tag {r} predicted miss"


@pytest.mark.parametrize("filter_bytes", [32, 64, 4])
def test_false_positive_rate_and_filter_width(filter_bytes):
    rng = np.random.default_rng(filter_bytes)
    pair = bloom_pair(1, 32, filter_bytes=filter_bytes)
    inserted = rng.choice(2 ** 24, size=32, replace=False)
    for t in inserted:
        pair = record(pair, 0, int(t))
    fp = 0
    probes = [int(p) for p in rng.choice(2 ** 24, size=200, replace=False)
              if p not in set(inserted.tolist())]
    for p in probes:
        hit, pair = predict(pair, 0, p)
        fp += hit
    for n in (8, 32, 64):
        assert t_bloom.false_positive_rate(filter_bytes, n) == \
            j_bloom.false_positive_rate(filter_bytes, n)
    if filter_bytes == 32:
        assert fp / len(probes) < max(
            3 * t_bloom.false_positive_rate(32, 32), 0.35)
    with pytest.raises(ValueError):
        t_bloom.make_state(1, 4, filter_bytes=3, device="cpu")


# ------------------------------------------------- counting-BF ablation

def test_counting_bloom_matches_reference_under_insert_and_remove():
    r = np.random.default_rng(3)
    js = j_bloom.make_counting_state(1, filter_bytes=128)
    ts = t_bloom.make_counting_state(1, filter_bytes=128, device="cpu")
    resident: set = set()
    for _ in range(300):
        tag = int(r.integers(0, 1 << 20))
        if tag in resident or (r.random() < 0.6 and len(resident) < 32):
            if tag not in resident:
                js = j_bloom.counting_insert(js, 0, jnp.uint32(tag))
                before = frozen(ts)
                ts2 = t_bloom.counting_insert(ts, 0, tag)
                untouched(before, ts)
                ts = ts2
                resident.add(tag)
        elif resident and r.random() < 0.5:
            victim = next(iter(resident))
            js = j_bloom.counting_remove(js, 0, jnp.uint32(victim))
            ts = t_bloom.counting_remove(ts, 0, victim)
            resident.discard(victim)
        np.testing.assert_array_equal(ts.counters.numpy(),
                                      np.asarray(js.counters))
        for t in list(resident)[:8]:
            assert bool(t_bloom.counting_query(ts, 0, t))
    probe = int(r.integers(0, 1 << 20))
    assert bool(t_bloom.counting_query(ts, 0, probe)) == \
        bool(j_bloom.counting_query(js, 0, jnp.uint32(probe)))


def test_counting_bloom_saturated_counters_stay():
    js = j_bloom.make_counting_state(1, filter_bytes=2)
    ts = t_bloom.make_counting_state(1, filter_bytes=2, device="cpu")
    for _ in range(17):
        js = j_bloom.counting_insert(js, 0, jnp.uint32(5))
        ts = t_bloom.counting_insert(ts, 0, 5)
    for _ in range(3):
        js = j_bloom.counting_remove(js, 0, jnp.uint32(5))
        ts = t_bloom.counting_remove(ts, 0, 5)
    np.testing.assert_array_equal(ts.counters.numpy(), np.asarray(js.counters))
    assert int(ts.counters.max()) == 15


@pytest.mark.parametrize("make", [
    lambda **kw: t_ts.make_state(4, 4, **kw),
    lambda **kw: t_bloom.make_state(4, 8, **kw),
    lambda **kw: t_bloom.make_counting_state(4, **kw),
    lambda **kw: t_ec.make_state(4, 4, compression=True, **kw)],
    ids=["tag_store", "bloom", "counting_bloom", "extended_cache"])
def test_make_state_defaults_to_the_card(make):
    """Each core state defaults to the card, as every entry point of the
    port (``engine.resolve_device``): without one it raises, and
    ``device="cpu"`` asks for the plain version."""
    state = make(device="cpu")
    assert all(t.device.type == "cpu" for t in state
               if isinstance(t, torch.Tensor))
    if not torch.cuda.is_available():
        with pytest.raises(t_engine.BackendError):
            make()
