"""The serving pool's five kernel entries: the reference's
``repro.kernels.ops`` (Pallas, interpret mode on the CPU) against the
port's ``repro_torch.kernels.ops`` (plain PyTorch versions on the CPU) on
the same seeded inputs.  The kernels are integer functions, so outputs
must be bit-identical (tolerance 0).

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
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import pool as t_pool  # noqa: E402

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


# ------------------------------------------------------------- wrappers

def test_wrappers_run_plain_versions_on_the_cpu_and_check_arguments():
    tags, valid, lru, req = _tag_inputs(16, 4, seed=9)
    t_pool.reset_launches()
    t_ops.tag_lookup(_t(tags), _t(valid), _t(lru), _t(req))
    blocks = _bdi_blocks(2)[:8]
    t_ops.bdi_decompress(*t_ops.bdi_compress(_t(blocks)))
    assert set(t_pool.launches.values()) == {0}
    assert t_pool.plain_runs == {
        "tag_lookup": 1, "bloom_query": 0, "bdi_compress": 1,
        "bdi_decompress": 1, "gather_blocks": 0, "cached_block_read": 0}
    with pytest.raises(TypeError, match="valid"):
        t_ops.tag_lookup(_t(tags), _t(valid.astype(np.int32)), _t(lru),
                         _t(req))
    with pytest.raises(ValueError, match="req"):
        t_ops.tag_lookup(_t(tags), _t(valid), _t(lru), _t(req[:3]))
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
    level, base, payload = t_ops.bdi_compress(_t(np.zeros((0, 32),
                                                          np.uint32)))
    assert payload.shape == (0, 32)
    out = t_ops.gather_blocks(_t(np.zeros((0, 4, 32), np.uint32)),
                              _t(np.zeros(0, np.int32)))
    assert out.shape == (0, 32)
