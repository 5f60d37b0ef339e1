"""The serving pool's kernel entries: the reference's
``repro.kernels.ops`` (Pallas, interpret mode on the CPU) against the
port's ``repro_torch.kernels.ops`` (plain PyTorch versions on the CPU) on
the same seeded inputs.  The kernels are integer functions, so outputs
must be bit-identical (tolerance 0).

The port's batched ``bloom_record`` is held to the reference pool's
per-key ``_bloom_record``, the by-row ``bloom_query`` to the reference's
query of the pre-gathered rows, ``read_rows`` to the reference pool's
``read_pages``, ``lookup_fill`` to the reference pool's round loop of
``tag_lookup`` with its fill rule, and ``page_write`` to the reference
pool's ``write_page``.

Sizes keep to what the reference's tiling accepts (S <= 256 or a
multiple of it for tag_lookup, Q <= 512 for bloom_query, N <= 256 for
BDI, S <= 64 or a multiple of it for gather_blocks); the port takes any.
"""
import jax  # noqa: F401  (both packages in one process, data as numpy)
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as j_ops  # noqa: E402
from repro.serving import paged_kv as j_kv  # noqa: E402
from repro_torch.core import address_separation as t_asep  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import pool as t_pool  # noqa: E402
from repro_torch.serving import paged_kv as t_kv  # noqa: E402
from torch_parity import pool_payload  # noqa: E402

MAX = (1 << 32) - 1


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy array as the port's tensor (uint32 as int32 bit pattern)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u(x) -> np.ndarray:
    """A port output as numpy uint32 (or bool/int32 unchanged)."""
    return x.numpy().view(np.uint32) if x.dtype == torch.int32 else x.numpy()


def _same(ref, port, what):
    ref = np.asarray(ref)
    port = port.numpy()
    if ref.dtype == np.uint32:
        port = port.view(np.uint32)
    assert ref.dtype == port.dtype, (what, ref.dtype, port.dtype)
    np.testing.assert_array_equal(ref, port, err_msg=what)


# ------------------------------------------------------------ tag lookup

def _tag_inputs(s, w, seed):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 6, size=(s, w)).astype(np.uint32)
    tags[rng.random((s, w)) < 0.1] = MAX
    valid = rng.random((s, w)) < 0.7
    valid[:3] = False                                # invalid rows
    lru = rng.integers(0, 1 << 12, size=(s, w)).astype(np.uint32)
    pick = rng.random((s, w))
    lru[pick < 0.2] = 0
    lru[pick > 0.8] = 0xFFF
    req = rng.integers(0, 6, size=s).astype(np.uint32)
    req[::7] = 0                                     # tag 0 requests
    req[1::11] = MAX
    req[2::13] = 12345                               # certain misses
    return tags, valid, lru, req


@pytest.mark.parametrize("s,w", [(256, 4), (256, 8), (64, 32), (512, 4)])
def test_tag_lookup_matches_reference(s, w):
    tags, valid, lru, req = _tag_inputs(s, w, seed=s + w)
    rh, rw, rl = j_ops.tag_lookup(jnp.asarray(tags), jnp.asarray(valid),
                                  jnp.asarray(lru), jnp.asarray(req))
    ph, pw, pl = t_ops.tag_lookup(_t(tags), _t(valid), _t(lru), _t(req))
    _same(rh, ph, "hit")
    _same(rw, pw, "way")
    _same(rl, pl, "new_lru")
    hit = np.asarray(rh).astype(bool)
    assert hit.any() and not hit.all()               # both kinds of row
    assert not hit[:3].any()                         # invalid rows miss


# ------------------------------------------------------ lookup and fill

def _fill_store(s, w, seed):
    """A conventional store with invalid ways, full sets (every other
    one), LRU ties (runs of 0 and 0xFFF) and sets holding a valid tag 0."""
    tags, valid, lru, _ = _tag_inputs(s, w, seed)
    valid[4::2] = True
    tags[5::9, 1] = 0                                # valid tag-0 pages
    valid[5::9, 1] = True
    lru[4::6] = lru[4::6, :1]                        # a whole row tied
    return tags, valid, lru


def _fill_requests(s, longest, seed):
    """Requests in batch order over a few sets, one set taking
    ``longest`` of them, with a tag repeated within a set's run and tag-0
    requests."""
    rng = np.random.default_rng(seed)
    others = rng.choice(s, size=13, replace=False)
    sets = np.concatenate([others[1:], [others[0]] * longest])
    rng.shuffle(sets)
    req = rng.integers(0, 8, size=len(sets)).astype(np.uint32)
    req[sets == others[0]] = [3, 9, 3, 0, 9, 5][:longest]
    req[sets == others[1]] = 0
    return sets.astype(np.int64), req


def _reference_rounds(tags, valid, lru, sets, req):
    """The reference pool's conventional tier on a bare store: its round
    loop over ``repro.kernels.tag_lookup.tag_lookup`` (interpret mode)
    with ``_conv_fill``'s victim rule, as records (round, hit, way,
    evicted, replaced tag) in batch order."""
    from repro.kernels.tag_lookup import tag_lookup as ref_lookup
    tags, valid, lru = (jnp.asarray(tags), jnp.asarray(valid),
                        jnp.asarray(lru))
    rec = np.zeros((5, len(sets)), np.int64)
    rec[0] = -1
    idx, req_set = np.arange(len(sets)), sets.copy()
    for rnd in range(4):
        first = j_kv._first_per_set(req_set)
        if first.size == 0:
            break
        sel = idx[first]
        q = np.zeros(tags.shape[0], np.uint32)
        q[sets[sel]] = req[sel]
        hit, way, lru = ref_lookup(tags, valid, lru, jnp.asarray(q))
        hit, way = np.asarray(hit, bool), np.asarray(way)
        for k in sel:
            s = sets[k]
            rec[:3, k] = rnd, hit[s], way[s] if hit[s] else 0
            if hit[s]:
                continue
            row_v = np.asarray(valid[s])
            row_l = np.asarray(lru[s]).astype(np.int64)
            row_l[~row_v] = -1
            w = int(np.argmin(row_l))
            rec[2:, k] = w, row_v[w], int(np.asarray(tags[s, w]))
            tags = tags.at[s, w].set(np.uint32(req[k]))
            valid = valid.at[s, w].set(True)
            lru = lru.at[s, w].set(0xFFF)
        req_set, idx = j_kv._drop_first(req_set, idx, first)
    return rec, tags, valid, lru


@pytest.mark.parametrize("s,w,longest", [(64, 4, 1), (64, 4, 4),
                                         (256, 8, 2), (256, 8, 6),
                                         (256, 32, 3)])
def test_lookup_fill_matches_the_reference_rounds(s, w, longest):
    """A batch's rounds and fills in one call leave the store and give
    the records of the reference's round loop: tag-0 lookups in the sets
    outside a round, fills of the LRU victim (invalid ways first, the
    lowest way on ties), a tag repeated in a run (a miss, then a hit),
    requests past the 4th of a set not run."""
    tags, valid, lru = _fill_store(s, w, seed=s + w + longest)
    sets, req = _fill_requests(s, longest, seed=longest)
    want, r_tags, r_valid, r_lru = _reference_rounds(tags, valid, lru, sets,
                                                     req)
    state = [_t(tags), _t(valid), _t(lru)]
    t_pool.reset_launches()
    rec = t_ops.lookup_fill(*state, sets, req)
    assert t_pool.plain_runs["lookup_fill"] == 1
    got = rec.numpy().astype(np.int64)
    got[4] &= MAX
    np.testing.assert_array_equal(got, want)
    _same(r_tags, state[0], "tags")
    _same(r_valid, state[1], "valid")
    _same(r_lru, state[2], "lru")
    assert (got[0] == min(longest, 4) - 1).any()
    assert ((got[0] == -1).sum() == max(longest - 4, 0))
    assert got[1].any() and not got[1].all()         # hits and fills
    assert got[3].any() and not got[3][got[1] == 0].all()


def test_fill_plan_orders_requests_by_set_stably():
    sets = np.asarray([4, 1, 4, 0, 1, 4], np.int64)
    req = np.asarray([10, 11, 12, 13, 14, MAX], np.uint32)
    plan, rounds = t_pool.fill_plan(sets, req, 6)
    assert rounds == 3 and plan.dtype == np.int32
    np.testing.assert_array_equal(plan[:7], [0, 1, 3, 3, 3, 6, 6])  # CSR
    np.testing.assert_array_equal(plan[7:13].view(np.uint32),
                                  [13, 11, 14, 10, 12, MAX])
    np.testing.assert_array_equal(plan[13:], [3, 1, 4, 0, 2, 5])  # slots
    more = np.asarray([1, 2], np.uint32)           # set 4 takes 5: 4 run
    assert t_pool.fill_plan(np.r_[sets, [4, 4]], np.r_[req, more], 6)[1] \
        == t_pool.ROUNDS == 4


# ----------------------------------------------------------- bloom query

def _bloom_inputs(q, words, seed):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 1 << 32, size=q, dtype=np.uint64).astype(
        np.uint32)
    tags[:4] = [0, 1, MAX, 0x80000000]
    filters = (rng.integers(0, 1 << 32, size=(q, words), dtype=np.uint64)
               & rng.integers(0, 1 << 32, size=(q, words), dtype=np.uint64)
               ).astype(np.uint32)                   # about a quarter set
    filters[::5] = 0                                 # empty filters
    return filters, tags


@pytest.mark.parametrize("q", [512, 100])
def test_bloom_query_matches_reference(q):
    filters, tags = _bloom_inputs(q, 8, seed=q)
    # insert every third tag, so that some queries must be present
    _, rm = j_ops.bloom_query(jnp.asarray(filters), jnp.asarray(tags))
    filters[::3] |= np.asarray(rm)[::3]
    rp, rm = j_ops.bloom_query(jnp.asarray(filters), jnp.asarray(tags))
    pp, pm = t_ops.bloom_query(_t(filters), _t(tags))
    _same(rp, pp, "pred")
    _same(rm, pm, "masks")
    pred = np.asarray(rp).astype(bool)
    assert pred[::3].all() and not pred.all()


@pytest.mark.parametrize("q", [512, 37])
def test_bloom_query_by_row_matches_reference(q):
    """``rows`` names each query's row of the whole store: the reference's
    query on the pre-gathered ``bf1[rows]`` gives the same answers."""
    store, _ = _bloom_inputs(40, 8, seed=q + 1)      # S = 40 rows
    _, tags = _bloom_inputs(q, 8, seed=q + 2)
    rows = np.random.default_rng(q).integers(0, 40, size=q).astype(np.int32)
    _, rm = j_ops.bloom_query(jnp.asarray(store[rows]), jnp.asarray(tags))
    store[rows[::3]] |= np.asarray(rm)[::3]          # some members
    rp, rm = j_ops.bloom_query(jnp.asarray(store[rows]), jnp.asarray(tags))
    pp, pm = t_ops.bloom_query(_t(store), _t(tags), _t(rows))
    _same(rp, pp, "pred")
    _same(rm, pm, "masks")
    pred = np.asarray(rp).astype(bool)
    assert pred.any() and not pred.all()


def test_bloom_query_row_outside_the_store_reads_an_empty_filter():
    store, tags = _bloom_inputs(8, 8, seed=5)
    store[:] = MAX                                   # every bit set
    rows = np.asarray([0, -1, 8, 7, 100, 3, -50, 1], np.int32)
    pred, masks = t_ops.bloom_query(_t(store), _t(tags), _t(rows))
    np.testing.assert_array_equal(pred.numpy(), [1, 0, 0, 1, 0, 1, 0, 1])
    _same(j_ops.bloom_query(jnp.asarray(store), jnp.asarray(tags))[1],
          masks, "masks depend on the tag only")


# ---------------------------------------------------------- Bloom record

def _record_batch(n_sets, k, seed):
    """K keys that revisit a few sets out of order, with repeated tags."""
    rng = np.random.default_rng(seed)
    sets = rng.choice(rng.permutation(n_sets)[:5], size=k)
    tags = rng.integers(0, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32)
    tags[3::4] = tags[rng.integers(0, 3, size=len(tags[3::4]))]
    return sets.astype(np.int32), tags


@pytest.mark.parametrize("words,seed", [(8, 0), (3, 1)])
def test_bloom_record_matches_the_reference_record(words, seed):
    """``bloom_record`` of a batch (its plain version, on the CPU) leaves
    the filters and MRU counts the reference pool's ``_bloom_record``
    leaves, called key by key; ways = 2 makes the swap fire several times
    within one set."""
    ref = j_kv.MorpheusPagePool(j_kv.PoolConfig(
        conv_sets=16, ext_sets_per_chip=8, num_cache_chips=2, ways=2,
        bloom_words=words))
    n = ref.bf1.shape[0]
    rng = np.random.default_rng(seed + 10)
    bf = (rng.integers(0, 1 << 32, size=(2, n, words), dtype=np.uint64)
          & rng.integers(0, 1 << 32, size=(2, n, words), dtype=np.uint64)
          ).astype(np.uint32)
    n_mru = rng.integers(0, 2, size=n).astype(np.int32)
    ref.bf1, ref.bf2 = jnp.asarray(bf[0]), jnp.asarray(bf[1])
    ref.n_mru = n_mru.copy()
    sets, tags = _record_batch(n, 48, seed)
    swaps = np.zeros(n, int)
    for s, t in zip(sets, tags):
        ref._bloom_record(int(s), int(t))
        swaps[s] += not np.asarray(ref.bf2[int(s)]).any()
    state = [_t(bf[0]), _t(bf[1]), torch.from_numpy(n_mru.copy())]
    t_pool.reset_launches()
    t_ops.bloom_record(*state, sets, tags, 2)
    assert t_pool.plain_runs["bloom_record"] == 1
    _same(ref.bf1, state[0], "bf1")
    _same(ref.bf2, state[1], "bf2")
    _same(ref.n_mru, state[2], "n_mru")
    assert swaps.max() >= 2


def test_record_plan_orders_keys_by_set_stably():
    sets = np.asarray([4, 1, 4, 0, 1, 4], np.int64)
    tags = np.asarray([10, 11, 12, 13, 14, MAX], np.uint32)
    plan, runs = t_pool.record_plan(sets, tags)
    assert runs == 3 and plan.dtype == np.int32
    np.testing.assert_array_equal(plan[:3], [0, 1, 4])          # run sets
    np.testing.assert_array_equal(plan[3:7], [0, 1, 3, 6])      # offsets
    np.testing.assert_array_equal(plan[7:].view(np.uint32),
                                  [13, 11, 14, 10, 12, MAX])    # batch order


def test_bloom_record_checks_its_arguments():
    bf = torch.zeros((4, 8), dtype=torch.int32)
    n_mru = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        t_ops.bloom_record(bf, bf.clone(), n_mru, [0, 4], [1, 2], 2)
    with pytest.raises(ValueError, match="sets and tags"):
        t_ops.bloom_record(bf, bf.clone(), n_mru, [0, 1], [1], 2)
    with pytest.raises(ValueError, match="n_mru"):
        t_ops.bloom_record(bf, bf.clone(), n_mru[:3], [0], [1], 2)
    t_ops.bloom_record(bf, bf.clone(), n_mru, [], [], 2)     # no keys
    assert not bf.any() and not n_mru.any()


# ------------------------------------------------------------------ BDI

def _bdi_blocks(seed):
    """256 blocks: each boundary delta, bases near 0 and near 2^32."""
    rng = np.random.default_rng(seed)
    deltas = [-129, -128, 127, 128, -32769, -32768, 32767, 32768, 0, 1]
    bases = [0, 5, 1 << 31, MAX, MAX - 3, 0x7FFFFFFF]
    rows = []
    for d in deltas:
        for b in bases:
            x = (b + rng.integers(-3, 4, size=32)) % (1 << 32)
            x[0] = b
            x[7] = (b + d) % (1 << 32)
            rows.append(x)
    while len(rows) < 256:                           # random widths
        b = int(rng.integers(0, 1 << 32))
        span = int(rng.choice([100, 30000, 1 << 31]))
        x = (b + rng.integers(-span, span, size=32)) % (1 << 32)
        x[0] = b
        rows.append(x)
    return np.asarray(rows, np.uint64).astype(np.uint32)


def test_bdi_levels_at_the_boundaries():
    blocks = _bdi_blocks(0)
    level, _, _ = t_ops.bdi_compress(_t(blocks))
    lv = level.numpy()[:48].reshape(8, 6)            # the boundary rows
    # -129 / 128 leave int8 (LOW); -32769 / 32768 leave int16 (UNCOMP)
    np.testing.assert_array_equal(lv[:, 0], [1, 0, 0, 1, 2, 1, 1, 2])
    assert (lv == lv[:, :1]).all(), "the base must not change the level"


@pytest.mark.parametrize("seed", [0, 1])
def test_bdi_compress_and_decompress_match_reference(seed):
    blocks = _bdi_blocks(seed)
    rl, rb, rp = j_ops.bdi_compress(jnp.asarray(blocks))
    pl, pb, pp = t_ops.bdi_compress(_t(blocks))
    _same(rl, pl, "level")
    _same(rb, pb, "base")
    _same(rp, pp, "payload")
    assert set(np.unique(np.asarray(rl))) == {0, 1, 2}
    rd = j_ops.bdi_decompress(rl, rb, rp)
    pd = t_ops.bdi_decompress(pl, pb, pp)
    _same(rd, pd, "decompressed")
    np.testing.assert_array_equal(_u(pd), blocks)    # round trip


def _write_cases(comp):
    """A reference pool of the engine's shape whose stores hold random
    tags (a tag in two ways of some sets), and keys of both tiers whose
    tags their set holds or not."""
    ref = j_kv.MorpheusPagePool(j_kv.PoolConfig(
        conv_sets=64, ext_sets_per_chip=32, ways=4, compression=comp))
    rng = np.random.default_rng(int(comp))
    for tier in ("conv", "ext"):
        shape = np.asarray(getattr(ref, f"{tier}_tags")).shape
        tags = rng.integers(0, 4, size=shape).astype(np.uint32)
        tags[::3, 2] = tags[::3, 0]                   # a tag held twice
        setattr(ref, f"{tier}_tags", jnp.asarray(tags))
        setattr(ref, f"{tier}_valid", jnp.asarray(rng.random(shape) < 0.8))
    total, conv = ref.cfg.amap.total_sets, ref.cfg.conv_sets
    keys = [tag * total + g for g in range(0, total, 5) for tag in (0, 2)]
    return ref, np.asarray(keys, np.uint32)


@pytest.mark.parametrize("comp", [True, False])
def test_page_write_matches_the_reference_write_page(comp):
    """``page_write`` (its plain version on the CPU) leaves the stores the
    reference's ``write_page`` leaves (``_probe``, then ``bdi_compress``
    and three ``.at[].set`` on the extended tier with compression, a raw
    write otherwise): both tiers, hits and misses, the first of two ways
    holding a tag, blocks of every BDI level."""
    ref, keys = _write_cases(comp)
    names = ("conv_tags", "conv_valid", "conv_data", "ext_tags", "ext_valid",
             "ext_data", "ext_level", "ext_base")
    st = {n: _t(np.array(getattr(ref, n))) for n in names}
    amap = t_kv.PoolConfig(conv_sets=64, ext_sets_per_chip=32, ways=4).amap
    t_pool.reset_launches()
    for k in keys:
        pay = pool_payload(int(k))
        ref.write_page(int(k), jnp.asarray(pay))
        tier, local = (int(x) for x in t_asep.route(amap, torch.tensor(
            [int(k)], dtype=torch.int64)))
        tag = int(t_asep.tag_of(amap, torch.tensor([int(k)],
                                                   dtype=torch.int64))[0])
        t = "conv" if tier == 0 else "ext"
        bdi = comp and tier == 1
        t_ops.page_write(st[f"{t}_tags"], st[f"{t}_valid"], st[f"{t}_data"],
                         st["ext_level"] if bdi else None,
                         st["ext_base"] if bdi else None, [local], [tag],
                         pay[None])
    assert t_pool.plain_runs["page_write"] == len(keys)
    for n in names:
        _same(getattr(ref, n), st[n], n)
    level = np.asarray(ref.ext_level)
    assert set(np.unique(level)) == ({0, 1, 2} if comp else {2})
    written = np.asarray(ref.conv_data).any(axis=2)
    assert written.any() and not written.all()


def test_page_write_checks_its_arguments():
    tags = torch.zeros((4, 4), dtype=torch.int32)
    valid = torch.ones((4, 4), dtype=torch.bool)
    data = torch.zeros((4, 4, 32), dtype=torch.int32)
    page = np.zeros((2, 32), np.uint32)
    with pytest.raises(ValueError, match="repeated"):
        t_ops.page_write(tags, valid, data, None, None, [1, 1], [5, 5], page)
    with pytest.raises(ValueError, match="outside"):
        t_ops.page_write(tags, valid, data, None, None, [1, 4], [5, 6], page)
    with pytest.raises(ValueError, match="both or neither"):
        t_ops.page_write(tags, valid, data, tags, None, [1, 2], [5, 5], page)
    with pytest.raises(ValueError, match="32 words"):
        t_ops.page_write(tags, valid, data[:, :, :16].contiguous(), tags,
                         tags.clone(), [1, 2], [5, 5], page[:, :16])
    with pytest.raises(ValueError, match="pages"):
        t_ops.page_write(tags, valid, data, None, None, [1, 2], [5, 5],
                         page[:1])
    t_ops.page_write(tags, valid, data, None, None, [1, 2], [0, 0], page + 7)
    assert (data[1:3, 0] == 7).all() and not data[0].any()  # first way


# ------------------------------------------------------------ block read

def _read_inputs(s, w, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << 32, size=(s, w, 32), dtype=np.uint64
                        ).astype(np.uint32)
    way = rng.integers(0, w, size=s).astype(np.int32)
    level = rng.integers(0, 3, size=s).astype(np.int32)
    base = rng.integers(0, 1 << 32, size=s, dtype=np.uint64).astype(
        np.uint32)
    base[:2] = MAX                                   # wrap-around
    return data, way, level, base


@pytest.mark.parametrize("s,w", [(64, 4), (64, 32), (128, 4)])
def test_gather_and_cached_read_match_reference(s, w):
    data, way, level, base = _read_inputs(s, w, seed=s * w)
    rg = j_ops.gather_blocks(jnp.asarray(data), jnp.asarray(way))
    pg = t_ops.gather_blocks(_t(data), _t(way))
    _same(rg, pg, "gather_blocks")
    np.testing.assert_array_equal(_u(pg), data[np.arange(s), way])
    rc = j_ops.cached_block_read(jnp.asarray(data), jnp.asarray(way),
                                 jnp.asarray(level), jnp.asarray(base))
    pc = t_ops.cached_block_read(_t(data), _t(way), _t(level), _t(base))
    _same(rc, pc, "cached_block_read")


def test_gather_of_a_way_out_of_range_reads_zeros():
    data, way, _, _ = _read_inputs(64, 4, seed=3)
    way[:5] = [-1, 4, 7, -100, 3]
    rg = j_ops.gather_blocks(jnp.asarray(data), jnp.asarray(way))
    pg = t_ops.gather_blocks(_t(data), _t(way))
    _same(rg, pg, "gather_blocks")
    assert not _u(pg)[:4].any()


def test_read_rows_matches_reference_read_pages():
    """``read_rows`` on a reference pool's stores and plan gives what the
    reference's ``read_pages`` gives: hits on both tiers, extended blocks
    at every BDI level, tier-2 rows as zeros."""
    ref = j_kv.MorpheusPagePool(j_kv.PoolConfig(conv_sets=64,
                                                ext_sets_per_chip=16,
                                                ways=4))
    total = ref.cfg.amap.total_sets
    keys = np.asarray([total * 3 + s for s in range(0, total, 5)], np.uint32)
    ref.lookup_batch(keys)
    for k in keys:
        ref.write_page(int(k), jnp.asarray(pool_payload(int(k))))
    fresh = np.asarray([total * 9 + 1, total * 9 + 70], np.uint32)
    plan = ref.lookup_batch(np.concatenate([keys, fresh]))
    assert set(plan.tier) == {0, 1, 2}
    ext = plan.tier == 1
    levels = np.asarray(ref.ext_level)[plan.set_idx[ext], plan.way[ext]]
    assert set(levels) == {0, 1, 2}
    want = np.asarray(ref.read_pages(plan))
    got = t_ops.read_rows(*[_t(np.array(getattr(ref, f))) for f in (
        "conv_data", "ext_data", "ext_level", "ext_base")],
        *[_t(c) for c in plan])
    _same(want, got, "read_rows")
    assert not want[plan.tier == 2].any() and want[plan.tier != 2].any()


def test_read_rows_outside_the_stores_reads_zeros():
    rng = np.random.default_rng(4)
    conv, _, _, _ = _read_inputs(6, 4, seed=5)
    ext, _, _, _ = _read_inputs(5, 8, seed=6)
    level = rng.integers(0, 3, size=(5, 8)).astype(np.int32)
    base = rng.integers(0, 1 << 32, size=(5, 8), dtype=np.uint64).astype(
        np.uint32)
    tier = np.asarray([0, 0, 0, 1, 1, 1, 2, 3, -1], np.int32)
    sets = np.asarray([5, 6, -1, 4, 5, 0, 0, 0, 0], np.int32)
    ways = np.asarray([3, 0, 0, 7, 0, 8, 0, 0, 0], np.int32)
    got = _u(t_ops.read_rows(_t(conv), _t(ext), _t(level), _t(base),
                             _t(tier), _t(sets), _t(ways)))
    np.testing.assert_array_equal(got[0], conv[5, 3])
    assert not got[[1, 2, 4, 5, 6, 7, 8]].any()
    row = np.asarray(j_ops.cached_block_read(
        jnp.asarray(ext[4:5]), jnp.asarray([7], np.int32),
        jnp.asarray(level[4, 7:8]), jnp.asarray(base[4, 7:8])))[0]
    np.testing.assert_array_equal(got[3], row)


# ------------------------------------------------------------- wrappers

def test_wrappers_run_plain_versions_on_the_cpu_and_check_arguments():
    tags, valid, lru, req = _tag_inputs(16, 4, seed=9)
    t_pool.reset_launches()
    t_ops.tag_lookup(_t(tags), _t(valid), _t(lru), _t(req))
    blocks = _bdi_blocks(2)[:8]
    t_ops.bdi_decompress(*t_ops.bdi_compress(_t(blocks)))
    assert set(t_pool.launches.values()) == {0}
    assert t_pool.plain_runs == {
        "tag_lookup": 1, "lookup_fill": 0, "bloom_query": 0,
        "bloom_record": 0, "bdi_compress": 1, "page_write": 0,
        "bdi_decompress": 1, "gather_blocks": 0, "cached_block_read": 0,
        "read_rows": 0}
    with pytest.raises(TypeError, match="valid"):
        t_ops.tag_lookup(_t(tags), _t(valid.astype(np.int32)), _t(lru),
                         _t(req))
    with pytest.raises(ValueError, match="req"):
        t_ops.tag_lookup(_t(tags), _t(valid), _t(lru), _t(req[:3]))
    with pytest.raises(ValueError, match="outside"):
        t_ops.lookup_fill(_t(tags), _t(valid), _t(lru), [0, 16], [1, 2])
    with pytest.raises(ValueError, match="sets and req"):
        t_ops.lookup_fill(_t(tags), _t(valid), _t(lru), [0, 1], [1])
    with pytest.raises(ValueError, match=r"\(N, 32\)"):
        t_ops.bdi_compress(_t(blocks[:, :16]))
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.bloom_query(_t(np.zeros((8, 4), np.uint32)).t(),
                          _t(np.zeros(4, np.uint32)))
    data, way, level, base = _read_inputs(8, 4, seed=1)
    with pytest.raises(ValueError, match="base"):
        t_ops.cached_block_read(_t(data), _t(way), _t(level),
                                _t(base[:2]))


def test_empty_inputs_on_the_cpu():
    z = np.zeros((0, 4), np.uint32)
    hit, way, lru = t_ops.tag_lookup(_t(z), _t(z.astype(bool)), _t(z),
                                     _t(np.zeros(0, np.uint32)))
    assert hit.shape == (0,) and lru.shape == (0, 4)
    store = [_t(x) for x in _fill_store(8, 4, seed=1)]
    before = [x.clone() for x in store]
    rec = t_ops.lookup_fill(*store, [], [])
    assert rec.shape == (5, 0)
    assert all(torch.equal(a, b) for a, b in zip(store, before))
    t_ops.page_write(store[0], store[1], torch.zeros((8, 4, 32),
                                                     dtype=torch.int32),
                     None, None, [], [], np.zeros((0, 32), np.uint32))
    level, base, payload = t_ops.bdi_compress(_t(np.zeros((0, 32),
                                                          np.uint32)))
    assert payload.shape == (0, 32)
    out = t_ops.gather_blocks(_t(np.zeros((0, 4, 32), np.uint32)),
                              _t(np.zeros(0, np.int32)))
    assert out.shape == (0, 32)
