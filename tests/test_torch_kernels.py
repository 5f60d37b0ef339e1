"""The CUDA kernels' wrappers (``repro_torch.kernels.engine_scan``, the
serving pool's ``repro_torch.kernels.pool`` and the attention kernels'
``repro_torch.kernels.attention``): argument checks on the CPU, and, on a
CUDA card only (marker ``gpu``), each CUDA kernel against its plain
PyTorch version (the pool's integer kernels bit for bit, attention within
the reference's tolerances), the pool on the card against the pool on
the CPU, and the LM on the card against the LM on the CPU.  This file
imports no JAX, so it runs on a card host that has none:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import address_separation as asep  # noqa: E402
from repro_torch.core import controller as ctl  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.kernels import engine_scan as scan  # noqa: E402
from repro_torch.kernels import pool as pool_ops  # noqa: E402
from repro_torch.kernels.pool import (  # noqa: E402
    bdi_compress_plain, bdi_decompress_plain, bloom_query_plain,
    bloom_record_plain, cached_block_read_plain, gather_blocks_plain,
    lookup_fill_plain, page_write_plain, read_rows_plain, tag_lookup_plain)
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402
from repro_torch.serving import paged_kv  # noqa: E402


def _cfg(ways=4, conv_sets=16, chips=3, sets_per_chip=5, **kw):
    amap = asep.make_map(conv_sets=conv_sets, num_cache_chips=chips,
                         sets_per_chip=sets_per_chip)
    return ctl.MorpheusConfig(amap=amap, conv_ways=ways, ext_ways=ways, **kw)


def _traces(seed=0, n=(900, 1300, 700), warm=(0, 200, 90), span=4096):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, span, size=k).astype(np.uint32),
             rng.random(k) < 0.3, rng.integers(0, 3, size=k).astype(np.int32),
             w) for k, w in zip(n, warm)]


def _packed(cfg, device, seed=0, **kw):
    pt = engine.to_device(engine.pack(cfg, _traces(seed, **kw)), device)
    warm = pt.warmup[:, None, None]
    return (pt, pt.conv_active & (pt.conv_pos >= warm),
            pt.ext_active & (pt.ext_pos >= warm))


def test_wrappers_check_their_arguments():
    cfg = _cfg()
    pt, cmask, emask = _packed(cfg, "cpu")
    args = [cfg, pt.conv_tag, pt.conv_write, pt.conv_active, cmask]
    with pytest.raises(TypeError, match="tag"):
        scan.conv_scan(cfg, pt.conv_tag.to(torch.int64), *args[2:])
    with pytest.raises(ValueError, match="shape"):
        scan.conv_scan(cfg, pt.conv_tag, pt.conv_write[:, :1], *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        scan.conv_scan(cfg, pt.conv_tag.transpose(1, 2).contiguous()
                       .transpose(1, 2), *args[2:])
    rows = ctl.conv_row_zero(cfg, (3, 15))
    with pytest.raises(ValueError, match="state.tags"):
        scan.conv_scan(*args, state=rows)
    eargs = [cfg, pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active,
             emask]
    with pytest.raises(TypeError, match="level"):
        scan.ext_scan(*eargs[:3], pt.ext_level.to(torch.int64), *eargs[4:])
    scan.reset_launches()
    i, f, out = scan.ext_scan(*eargs, keep_state=True)
    assert scan.launches == {"conv_scan": 0, "ext_scan": 0}  # plain on CPU
    assert scan.plain_runs == {"conv_scan": 0, "ext_scan": 1}
    assert i.shape == (3, cfg.amap.ext_sets, len(scan.INT_FIELDS))
    assert f.dtype == torch.float32 and out.bf1.shape == (3, 15, 8)


def test_stats_vectors_round_trip():
    s = ctl.zero_stats((2, 3))
    s = s._replace(writebacks=torch.full((2, 3), 7, dtype=torch.int32),
                   noc_bytes=torch.full((2, 3), 1.5))
    back = scan.vecs_to_stats(*scan.stats_to_vecs(s))
    for a, b in zip(s, back):
        assert torch.equal(a, b)
    assert scan.INT_FIELDS[-1] == "bloom_swaps"
    assert scan.FLOAT_FIELDS == ("latency_ns", "energy_nJ", "noc_bytes",
                                 "conv_bytes", "dram_bytes")


def test_launch_shape_needs_a_card():
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        scan.launch_shape("ext", 128, 5760, torch.device("cpu"))


# ---------------------------------------------------- on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _close(kernel, plain, ctx):
    ki, kf, krows = kernel
    pi, pf, prows = plain
    assert torch.equal(ki, pi), ctx
    tol = 1e-3 * pf.abs().clamp_min(1.0)
    assert bool(((kf - pf).abs() <= tol).all()), ctx
    if prows is not None:
        for name, k, p in zip(prows._fields, krows, prows):
            assert torch.equal(k, p), f"{ctx} state.{name}"


@pytest.mark.gpu
@pytest.mark.parametrize("pred,comp,ways", list(itertools.product(
    list(ctl.Predictor), [False, True], [4, 32])))
def test_kernels_match_plain_versions(cuda_device, pred, comp, ways):
    cfg = _cfg(ways=ways, predictor=pred, compression=comp)
    pt, cmask, emask = _packed(cfg, cuda_device, ways + int(comp))
    for keep in (False, True):
        args = (cfg, pt.conv_tag, pt.conv_write, pt.conv_active, cmask)
        _close(scan.conv_scan(*args, keep_state=keep),
               scan.conv_scan_plain(*args, keep_state=keep),
               f"conv/{pred.value}/{comp}/{ways}")
        args = (cfg, pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active,
                emask)
        _close(scan.ext_scan(*args, keep_state=keep),
               scan.ext_scan_plain(*args, keep_state=keep),
               f"ext/{pred.value}/{comp}/{ways}")


@pytest.mark.gpu
@pytest.mark.parametrize("ways", [4, 16, 64])
def test_stateful_kernels_match_plain_versions(cuda_device, ways):
    """State rows carried in (and out) of both tiers; 64 ways with
    compression is the widest extended set (256 ways)."""
    cfg = (_cfg(ways=ways, compression=True) if ways <= 32 else
           ctl.MorpheusConfig(amap=_cfg().amap, conv_ways=32, ext_ways=ways,
                              compression=True))
    pt, cmask, emask = _packed(cfg, cuda_device, ways)
    cargs = (cfg, pt.conv_tag, pt.conv_write, pt.conv_active, cmask)
    eargs = (cfg, pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active,
             emask)
    _, _, crows = scan.conv_scan_plain(*cargs, keep_state=True)
    _, _, erows = scan.ext_scan_plain(*eargs, keep_state=True)
    _close(scan.conv_scan(*cargs, state=crows, keep_state=True),
           scan.conv_scan_plain(*cargs, state=crows, keep_state=True),
           f"conv-state/{ways}")
    _close(scan.ext_scan(*eargs, state=erows, keep_state=True),
           scan.ext_scan_plain(*eargs, state=erows, keep_state=True),
           f"ext-state/{ways}")


@pytest.mark.gpu
def test_epoch_partition_on_the_card(cuda_device):
    cfg = _cfg(compression=True)
    (trace,) = _traces(21, n=(800,), warm=(150,))
    mono = engine.simulate_batch(cfg, [trace], device=cuda_device)
    state = engine.init_state(cfg, 1, device=cuda_device)
    lo = 0
    for hi in (97, 400, 401, 800):
        pt = engine.pack(cfg, [(trace[0][lo:hi], trace[1][lo:hi],
                                trace[2][lo:hi], trace[3])], pos0=[lo])
        state, _ = engine.advance_packed(cfg, pt, state, device=cuda_device)
        lo = hi
    for f in ctl._INT_FIELDS:
        assert torch.equal(getattr(mono, f), getattr(state.stats, f)), f
    cpu = engine.simulate_batch(cfg, [trace], device="cpu")
    for f in ctl._INT_FIELDS:
        assert int(getattr(cpu, f)[0]) == int(getattr(state.stats, f)[0]), f


@pytest.mark.gpu
def test_empty_input_launches_nothing(cuda_device):
    cfg = _cfg()
    z = torch.zeros((2, cfg.amap.conv_sets, 0), device=cuda_device)
    rows = ctl.conv_row_zero(cfg, (2, cfg.amap.conv_sets), cuda_device)
    rows = rows._replace(lru=torch.full_like(rows.lru, 7))
    scan.reset_launches()
    i, f, out = scan.conv_scan(cfg, z.to(torch.int32), z.bool(), z.bool(),
                               z.bool(), state=rows, keep_state=True)
    assert scan.launches["conv_scan"] == 0
    assert not i.any() and not f.any() and torch.equal(out.lru, rows.lru)


@pytest.mark.gpu
@pytest.mark.parametrize("tier,field", [("conv", "lru"), ("conv", "tags"),
                                        ("ext", "lru"), ("ext", "size"),
                                        ("ext", "tags")])
def test_scans_raise_on_out_of_contract_state(cuda_device, tier, field):
    """State-in rows the engine does not make (lru 0x1000, an extended
    size of 48 bytes, a tag valid in two ways of a set) raise before a
    launch: the packed way words cannot hold them."""
    cfg = _cfg(compression=True)
    pt, cmask, emask = _packed(cfg, cuda_device, 5)
    if tier == "conv":
        kernel, plain = scan.conv_scan, scan.conv_scan_plain
        args = (cfg, pt.conv_tag, pt.conv_write, pt.conv_active, cmask)
    else:
        kernel, plain = scan.ext_scan, scan.ext_scan_plain
        args = (cfg, pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active,
                emask)
    rows = plain(*args, keep_state=True)[2]
    kernel(*args, state=rows)                    # the engine's rows pass
    w = int(rows.valid[1, 3].to(torch.int32).argmax())
    if field == "lru":
        rows.lru[1, 3, w] = 0x1000
    elif field == "size":
        rows.size[1, 3, w] = 48
    else:
        other = (w + 1) % rows.tags.shape[-1]
        rows.tags[1, 3, other] = rows.tags[1, 3, w]
        rows.valid[1, 3, other] = True
    scan.reset_launches()
    msg = {"lru": "lru 4096", "size": "size 48", "tags": "valid in two ways"}
    with pytest.raises(ValueError, match=msg[field]):
        kernel(*args, state=rows)
    assert scan.launches[f"{tier}_scan"] == 0


def _columns(seed, b, s, length, span):
    """Random packed (B, S, L) request columns (tag, write, level,
    active, mask) in the dense layout ``engine.pack`` makes (an active
    prefix of each set's row), except that set 0 of each trace has no
    active slot and set 1 has active slots in its last 32-slot chunk
    only."""
    rng = np.random.default_rng(seed)
    shape = (b, s, length)
    n = rng.integers(1, length + 1, size=(b, s))
    active = np.arange(length)[None, None, :] < n[..., None]
    active[:, 0] = False
    last = (length - 1) // 32 * 32
    active[:, 1] = False
    active[:, 1, last + int(rng.integers(0, length - last)):] = True
    tag = rng.integers(0, span, size=shape).astype(np.uint32).view(np.int32)
    cols = (tag, rng.random(shape) < 0.3,
            rng.integers(0, 3, size=shape).astype(np.int32), active,
            active & (rng.random(shape) < 0.8))
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in cols)


def _scan_matches_plain(cfg, tier, cols, dev, ctx):
    """The ``tier`` ("conv" or "ext") kernel against its plain version on
    ``cols``: cold with and without the final rows, then carrying the
    plain version's final rows in, with and without rows out."""
    cols = [c.to(dev) for c in cols]
    if tier == "conv":
        kernel, plain = scan.conv_scan, scan.conv_scan_plain
        args = (cfg, cols[0], cols[1], cols[3], cols[4])
    else:
        kernel, plain = scan.ext_scan, scan.ext_scan_plain
        args = (cfg, *cols)
    scan.reset_launches()
    for keep in (False, True):
        _close(kernel(*args, keep_state=keep), plain(*args, keep_state=keep),
               f"{ctx} cold keep={keep}")
    rows = plain(*args, keep_state=True)[2]
    for keep in (False, True):
        _close(kernel(*args, state=rows, keep_state=keep),
               plain(*args, state=rows, keep_state=keep),
               f"{ctx} state keep={keep}")
    assert scan.launches[f"{tier}_scan"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("ways", [1, 31, 32])
def test_conv_kernel_at_way_boundaries(cuda_device, ways):
    """1, 31 and 32 conventional ways over 3 x 13 sets (not a multiple of
    a block's 4 sets), with empty sets and last-chunk-only sets."""
    cfg = _cfg(ways=ways)
    cols = _columns(ways, 3, 13, 200, span=2 * ways + 3)
    _scan_matches_plain(cfg, "conv", cols, cuda_device, f"conv {ways} ways")


@pytest.mark.gpu
@pytest.mark.parametrize("ext_ways,comp,pred", [
    (32, False, ctl.Predictor.BLOOM),       # 32 ways: one a lane
    (33, False, ctl.Predictor.PERFECT),     # 33: two a lane, one present
    (16, True, ctl.Predictor.BLOOM),        # 64
    (65, False, ctl.Predictor.NONE),        # 65: four a lane
    (32, True, ctl.Predictor.BLOOM),        # 128
    (129, False, ctl.Predictor.PERFECT),    # 129: eight a lane
    (64, True, ctl.Predictor.BLOOM)],       # 256, the widest set
    ids=["32", "33", "64", "65", "128", "129", "256"])
def test_ext_kernel_at_way_boundaries(cuda_device, ext_ways, comp, pred):
    cfg = ctl.MorpheusConfig(amap=_cfg().amap, conv_ways=4, ext_ways=ext_ways,
                             compression=comp, predictor=pred)
    ways = cfg.ext_max_ways
    cols = _columns(ways, 2, 15, 300, span=2 * ways + 5)
    _scan_matches_plain(cfg, "ext", cols, cuda_device, f"ext {ways} ways")


@pytest.mark.gpu
def test_scan_kernels_at_length_1024(cuda_device):
    """L = 1024, the conventional length of the BL configuration."""
    cfg = _cfg(ways=32, compression=True)
    cols = _columns(1024, 2, 9, 1024, span=96)
    _scan_matches_plain(cfg, "conv", cols, cuda_device, "conv L=1024")
    _scan_matches_plain(cfg, "ext", cols, cuda_device, "ext L=1024")


@pytest.mark.gpu
def test_ext_kernel_four_evictions(cuda_device):
    """Compression with an 8-way, 256-byte set: eight HIGH (32-byte) dirty
    blocks fill it, and the UNCOMP (128-byte) block after them evicts
    four; then a stream where every ninth block is UNCOMP."""
    cfg = _cfg(ways=2, compression=True)
    b, s, length = 2, 15, 72
    pos = np.arange(length)
    tag = np.broadcast_to(pos + 1000 * np.arange(s)[:, None], (b, s, length))
    level = np.broadcast_to(np.where(pos % 9 == 8, 2, 0), (b, s, length))
    ones = np.ones((b, s, length), bool)
    cols = [torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device) for c in
            (tag.astype(np.int32), ones, level.astype(np.int32), ones)]
    ninth = torch.from_numpy(np.broadcast_to(pos == 8, (b, s, length)).copy())
    args = (cfg, *cols, ninth.to(cuda_device))
    kernel, plain = scan.ext_scan(*args), scan.ext_scan_plain(*args)
    _close(kernel, plain, "ext four evictions")
    wb = scan.INT_FIELDS.index("writebacks")
    assert bool((plain[0][..., wb] == 4).all())
    every = torch.from_numpy(ones)
    _scan_matches_plain(cfg, "ext", [c.cpu() for c in cols] + [every],
                        cuda_device, "ext evictions")


@pytest.mark.gpu
def test_launch_shape_reports_the_launch(cuda_device):
    for tier, ways, n_sets in (("conv", 32, 2560), ("ext", 128, 5761)):
        shape = scan.launch_shape(tier, ways, n_sets, cuda_device)
        assert shape["blocks"] == -(-n_sets // (shape["threads"] // 32))
        assert shape["resident_blocks_per_sm"] >= 1
        assert shape["waves"] == pytest.approx(
            shape["blocks"] / (shape["resident_blocks_per_sm"]
                               * shape["sms"]))


# ------------------------------------------- pool kernels, on the card only

def _u32(rng, shape, hi=1 << 32):
    """Random uint32 values as an int32 bit-pattern tensor."""
    a = rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


def _equal(kernel, plain, ctx):
    for i, (k, p) in enumerate(zip(kernel, plain)):
        assert k.dtype == p.dtype and torch.equal(k, p), f"{ctx} output {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("s,w", [(1000, 4), (513, 8), (300, 32), (77, 40),
                                 (9, 1), (100, 12)])
def test_tag_lookup_kernel_matches_plain(cuda_device, s, w):
    rng = np.random.default_rng(s * w)
    tags = _u32(rng, (s, w), hi=5)
    valid = torch.from_numpy(rng.random((s, w)) < 0.7)
    lru = _u32(rng, (s, w), hi=1 << 12)
    lru[:, 0] = 0
    lru[::3, -1] = 0xFFF
    req = _u32(rng, (s,), hi=5)
    req[::5] = 7                                    # certain misses
    args = [x.to(cuda_device) for x in (tags, valid, lru, req)]
    pool_ops.reset_launches()
    out = pool_ops.tag_lookup(*args)
    assert pool_ops.launches["tag_lookup"] == 1
    _equal(out, tag_lookup_plain(*args), f"tag_lookup {s}x{w}")
    hit = out[0].bool()
    assert hit.any() and not hit.all()


def _conv_store(rng, s, w):
    """tags (few values), valid bits (every other set full) and LRU
    counters (ties, a valid tag 0 in some sets)."""
    tags = _u32(rng, (s, w), hi=6)
    valid = torch.from_numpy(rng.random((s, w)) < 0.7)
    valid[::2] = True
    tags[5::9, 0] = 0
    lru = _u32(rng, (s, w), hi=1 << 12)
    lru[::3] = lru[::3, :1]
    lru[1::3, -1] = 0xFFF
    return [tags, valid, lru]


def _unaligned(x, dev):
    """``x`` on ``dev`` as a view one element into a buffer, so its rows
    are not 16-byte aligned and the kernel takes its scalar loads."""
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device=dev)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("s,w,k,offset", [
    (64, 4, 1, False), (64, 4, 300, False),       # the engine pool
    (51200, 8, 512, False),                       # phase 8's store
    (300, 40, 700, False), (100, 132, 400, False), (37, 7, 90, False),
    (64, 8, 200, True)])
def test_lookup_fill_kernel_matches_plain(cuda_device, s, w, k, offset):
    """A batch's rounds and fills in one launch, in place, equal the plain
    round loop on a copy of the same state: records, tags, valid bits and
    LRU counters."""
    rng = np.random.default_rng(s + w + k)
    sets = rng.integers(0, s, size=k)
    sets[::4] = sets[0]                             # a set past 4 rounds
    req = rng.integers(0, 8, size=k).astype(np.uint32)
    card = [_unaligned(x, cuda_device) if offset else x.to(cuda_device)
            for x in _conv_store(rng, s, w)]
    assert bool(card[0].data_ptr() % 16) == offset
    plain = [x.clone() for x in card]
    pool_ops.reset_launches()
    rec = pool_ops.lookup_fill(*card, sets, req)
    assert pool_ops.launches["lookup_fill"] == 1
    want = lookup_fill_plain(*plain, sets, req)
    _equal((rec, *card), (want, *plain), f"lookup_fill {s}x{w}, {k} keys")
    if k > 1:               # hits, evictions, 4 rounds, requests not run
        assert rec[1].any() and rec[3].any()
        assert (rec[0] == 3).any() and (rec[0] == -1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("sc,wc,se,we,n", [(64, 4, 128, 16, 1),
                                           (64, 4, 128, 16, 300),
                                           (51200, 8, 51200, 32, 512)])
def test_page_write_kernel_matches_plain(cuda_device, sc, wc, se, we, n):
    """The probe, the compression and the store write in one launch, on
    the engine pool's and phase 8's stores, each tier with and without
    BDI, pages from the host and on the card, hits and misses, tags held
    in two ways."""
    rng = np.random.default_rng(sc + se + n)
    for (s, w), bdi in (((sc, wc), False), ((se, we), False), ((se, we),
                                                               True)):
        tags = _u32(rng, (s, w), hi=4)
        tags[:, 1] = tags[:, 0]
        valid = torch.from_numpy(rng.random((s, w)) < 0.8)
        data = _u32(rng, (s, w, 32))
        level = torch.from_numpy(rng.integers(0, 3, size=(s, w)).astype(
            np.int32))
        base = _u32(rng, (s, w))
        keys = rng.choice(s * 5, size=n, replace=False)
        sets, ptags = keys // 5, (keys % 5).astype(np.uint32)
        pages = _bdi_blocks(rng, n).numpy().view(np.uint32)
        card = [x.to(cuda_device).clone() for x in (tags, valid, data, level,
                                                     base)]
        if not bdi:
            card[3] = card[4] = None
        plain = [x.clone() if x is not None else None for x in card]
        for src in (pages, torch.from_numpy(pages.view(np.int32)).to(
                cuda_device)):
            pool_ops.reset_launches()
            pool_ops.page_write(*card, sets, ptags, src)
            assert pool_ops.launches["page_write"] == 1
            page_write_plain(*plain, sets, ptags, src)
            _equal([x for x in card if x is not None],
                   [x for x in plain if x is not None],
                   f"page_write ({s}, {w}) bdi={bdi}")
        if n > 1:
            assert not torch.equal(card[2].cpu(), data)


@pytest.mark.gpu
def test_pool_wrappers_raise_on_bad_arguments_on_the_card(cuda_device):
    wide = torch.zeros((4, 300), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="ways"):
        pool_ops.tag_lookup(wide, wide.bool(), wide, wide[:, 0].contiguous())
    with pytest.raises(ValueError, match="ways"):
        pool_ops.lookup_fill(wide, wide.bool(), wide, [0], [1])
    tags = torch.zeros((4, 4), dtype=torch.int32, device=cuda_device)
    data = torch.zeros((4, 4, 32), dtype=torch.int32, device=cuda_device)
    pages = np.zeros((2, 32), np.uint32)
    with pytest.raises(ValueError, match="repeated"):
        pool_ops.page_write(tags, tags.bool(), data, None, None, [1, 1],
                            [3, 3], pages)
    with pytest.raises(ValueError, match="pages: on cpu"):
        pool_ops.page_write(tags, tags.bool(), data, None, None, [1, 2],
                            [3, 3], torch.zeros((2, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        pool_ops.lookup_fill(tags, tags.bool(), tags, [4], [1])
    with pytest.raises(ValueError, match=r"\(N, 32\)"):
        pool_ops.bdi_compress(data[0, :, :16].contiguous())
    assert set(pool_ops.launches.values()) <= {0, 1}


@pytest.mark.gpu
@pytest.mark.parametrize("q,words", [(4097, 8), (1, 8), (300, 3)])
def test_bloom_query_kernel_matches_plain(cuda_device, q, words):
    rng = np.random.default_rng(q + words)
    filters = (_u32(rng, (q, words)) & _u32(rng, (q, words))).to(cuda_device)
    tags = _u32(rng, (q,)).to(cuda_device)
    _, masks = bloom_query_plain(filters, tags)
    filters[::2] |= masks[::2]                      # half are members
    _equal(pool_ops.bloom_query(filters, tags),
           bloom_query_plain(filters, tags), f"bloom_query {q}x{words}")


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,words", [(4096, 51200, 8), (1, 64, 8),
                                       (300, 7, 40)])
def test_bloom_query_by_row_kernel_matches_plain(cuda_device, q, n, words):
    rng = np.random.default_rng(q + n)
    store = (_u32(rng, (n, words)) & _u32(rng, (n, words))).to(cuda_device)
    tags = _u32(rng, (q,)).to(cuda_device)
    rows = torch.from_numpy(rng.integers(-2, n + 2, size=q).astype(np.int32)
                            ).to(cuda_device)        # some outside
    _, masks = bloom_query_plain(store, tags, rows)
    inside = rows[::2][(rows[::2] >= 0) & (rows[::2] < n)].long()
    store[inside] |= masks[::2][(rows[::2] >= 0) & (rows[::2] < n)]
    pool_ops.reset_launches()
    out = pool_ops.bloom_query(store, tags, rows)
    assert pool_ops.launches["bloom_query"] == 1
    _equal(out, bloom_query_plain(store, tags, rows), f"bloom_query rows {q}")
    assert out[0].any() or q == 1


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,words,ways", [(51200, 4096, 8, 8),
                                            (20, 700, 8, 2), (9, 300, 40, 3),
                                            (5, 64, 1, 2), (3, 40, 200, 2)])
def test_bloom_record_kernel_matches_plain(cuda_device, n, k, words, ways):
    """A batch's records in one launch equal the per-key plain version:
    random sets with repeats, one set taking a quarter of the keys, tags
    repeated (bf2 hits), and swaps within a run."""
    rng = np.random.default_rng(n + k + words)
    sets = rng.integers(0, n, size=k)
    sets[::4] = sets[1]
    tags = rng.integers(0, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32)
    tags[3::5] = tags[rng.integers(0, 3, size=len(tags[3::5]))]
    bf = _u32(rng, (2, n, words)) & _u32(rng, (2, n, words))
    n_mru = torch.from_numpy(rng.integers(0, ways, size=n).astype(np.int32))
    card = [x.to(cuda_device) for x in (bf[0], bf[1], n_mru)]
    plain = [x.clone() for x in card]
    pool_ops.reset_launches()
    pool_ops.bloom_record(*card, sets, tags, ways)
    assert pool_ops.launches["bloom_record"] == 1
    bloom_record_plain(*plain, sets, tags, ways)
    _equal(card, plain, f"bloom_record {n}x{words}, {k} keys")
    assert not torch.equal(card[0].cpu(), bf[0])


def _read_stores(rng, sc, wc, se, we, words, dev):
    conv = _u32(rng, (sc, wc, words)).to(dev)
    ext = _u32(rng, (se, we, words)).to(dev)
    level = torch.from_numpy(rng.integers(0, 3, size=(se, we)).astype(
        np.int32)).to(dev)
    return conv, ext, level, _u32(rng, (se, we)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("sc,wc,se,we,words,n", [
    (51200, 8, 51200, 32, 32, 512),          # the full-scale pool's stores
    (64, 4, 128, 16, 32, 1), (7, 8, 9, 32, 40, 300), (1, 1, 1, 1, 32, 8)])
def test_read_rows_kernel_matches_plain(cuda_device, sc, wc, se, we, words,
                                        n):
    """Both tiers, tier 2, and sets and ways outside their store."""
    rng = np.random.default_rng(sc + se + n)
    stores = _read_stores(rng, sc, wc, se, we, words, cuda_device)
    cols = [torch.from_numpy(c.astype(np.int32)).to(cuda_device) for c in (
        rng.integers(0, 3, size=n),
        rng.integers(-1, max(sc, se) + 1, size=n),
        rng.integers(-1, max(wc, we) + 1, size=n))]
    pool_ops.reset_launches()
    out = pool_ops.read_rows(*stores, *cols)
    assert pool_ops.launches["read_rows"] == 1
    assert torch.equal(out, read_rows_plain(*stores, *cols))


def _bdi_blocks(rng, n):
    """Blocks of every level, boundary deltas and bases near 2^32."""
    base = rng.integers(0, 1 << 32, size=(n, 1), dtype=np.int64)
    base[::4] = (1 << 32) - 2
    step = np.asarray([1, 1000, 1 << 24])[rng.integers(0, 3, size=(n, 1))]
    x = base + rng.integers(-127, 128, size=(n, 32)) * step // 127
    x[:, 0] = base[:, 0]
    edge = np.asarray([-129, -128, 127, 128, -32769, -32768, 32767, 32768])
    x[: 8 * (n // 8), 5] = base[: 8 * (n // 8), 0] + np.tile(edge, n // 8)
    a = (x % (1 << 32)).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_bdi_kernels_match_plain_and_round_trip(cuda_device, n):
    blocks = _bdi_blocks(np.random.default_rng(n), n).to(cuda_device)
    comp = pool_ops.bdi_compress(blocks)
    _equal(comp, bdi_compress_plain(blocks), f"bdi_compress {n}")
    if n >= 1000:
        assert set(comp[0].tolist()) == {0, 1, 2}
    back = pool_ops.bdi_decompress(*comp)
    assert torch.equal(back, bdi_decompress_plain(*comp))
    assert torch.equal(back, blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("s,w,words", [(999, 4, 32), (64, 32, 32),
                                       (1, 1, 32), (50, 8, 40)])
def test_block_read_kernel_matches_plain(cuda_device, s, w, words):
    rng = np.random.default_rng(s + w + words)
    data = _u32(rng, (s, w, words)).to(cuda_device)
    way = torch.from_numpy(rng.integers(-1, w + 1, size=s).astype(np.int32)
                           ).to(cuda_device)            # some out of range
    level = torch.from_numpy(rng.integers(0, 3, size=s).astype(np.int32)
                             ).to(cuda_device)
    base = _u32(rng, (s,)).to(cuda_device)
    assert torch.equal(pool_ops.gather_blocks(data, way),
                       gather_blocks_plain(data, way))
    assert torch.equal(pool_ops.cached_block_read(data, way, level, base),
                       cached_block_read_plain(data, way, level, base))


@pytest.mark.gpu
def test_pool_kernels_launch_nothing_on_empty_inputs(cuda_device):
    z = torch.zeros((0, 4), dtype=torch.int32, device=cuda_device)
    e = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    pool_ops.reset_launches()
    pool_ops.tag_lookup(z, z.bool(), z, e)
    four = torch.zeros((4, 4), dtype=torch.int32, device=cuda_device)
    assert pool_ops.lookup_fill(four, four.bool(), four, [], []).shape \
        == (5, 0)
    pool_ops.page_write(four, four.bool(), torch.zeros(
        (4, 4, 32), dtype=torch.int32, device=cuda_device), None, None, [],
        [], np.zeros((0, 32), np.uint32))
    pool_ops.bloom_query(z, e)
    level, base, payload = pool_ops.bdi_compress(
        torch.zeros((0, 32), dtype=torch.int32, device=cuda_device))
    pool_ops.bdi_decompress(level, base, payload)
    data = torch.zeros((0, 4, 32), dtype=torch.int32, device=cuda_device)
    pool_ops.gather_blocks(data, e)
    pool_ops.cached_block_read(data, e, e, e)
    store = torch.zeros((4, 4, 32), dtype=torch.int32, device=cuda_device)
    flat = torch.zeros((4, 4), dtype=torch.int32, device=cuda_device)
    pool_ops.bloom_query(flat, e, e)
    pool_ops.bloom_record(flat, flat.clone(), flat[0], [], [], 2)
    assert pool_ops.read_rows(store, store, flat, flat, e, e, e).shape == (
        0, 32)
    assert set(pool_ops.launches.values()) == {0}
    assert set(pool_ops.plain_runs.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(conv_sets=64, ext_sets_per_chip=32,
                                     ways=4),
                                dict(predictor="none", compression=False)])
def test_pool_on_the_card_matches_the_cpu(cuda_device, kw):
    """The pool on the card (kernels) replays a stream exactly as on the
    CPU (plain versions): plans, stats, pages read and state."""
    cfg = paged_kv.PoolConfig(**kw)
    card = paged_kv.MorpheusPagePool(cfg, cuda_device)
    cpu = paged_kv.MorpheusPagePool(cfg, "cpu")
    rng = np.random.default_rng(3)
    total = cfg.amap.total_sets
    pool_ops.reset_launches()
    for b in range(4):
        keys = rng.integers(0, 3 * total, size=96).astype(np.uint32)
        plans = [p.lookup_batch(keys) for p in (card, cpu)]
        for a, c in zip(*plans):
            assert np.array_equal(a, c), b
        for k in keys[plans[0].tier == 2]:
            pay = rng.integers(0, 1 << 16, size=32).astype(np.uint32)
            card.write_page(int(k), pay)
            cpu.write_page(int(k), pay)
        assert torch.equal(card.read_pages(plans[0]).cpu(),
                           cpu.read_pages(plans[1]))
        assert card.stats == cpu.stats
    a, c = paged_kv.pool_to_numpy(card), paged_kv.pool_to_numpy(cpu)
    for name in paged_kv.STATE_FIELDS:
        assert np.array_equal(a[name], c[name]), name
    runs = pool_ops.launches
    assert runs["lookup_fill"] and runs["bloom_query"] and runs["read_rows"]
    assert runs["bloom_record"] == runs["bloom_query"]
    assert runs["page_write"] and not runs["tag_lookup"] + runs[
        "bdi_compress"]


# ------------------------------------- attention kernels, on the card only

# (atol, rtol) of (decode, flash) by input dtype: f32 as the reference's
# test; bf16 from the card's measured errors with room on both sides
# (decode's output is f32, about 3e-4 off; flash's is bf16, one ulp off),
# well under the reference's 2e-2 / 3e-2, which a wrong scale would pass
ATT_TOL = {torch.float32: ((2e-5, 2e-5), (2e-4, 2e-4)),
           torch.bfloat16: ((2e-3, 2e-3), (4e-3, 1e-2))}


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,hd,t", [
    (8, 32, 8, 128, 1088), (2, 8, 2, 64, 77), (3, 7, 1, 16, 300),
    (1, 16, 16, 256, 129), (2, 12, 4, 96, 1),
    # the chunk choice at both ends, G in {1, 2, 4, 7, 8}, and head dims
    # through the padding (40) and every size the configs use
    (1, 8, 1, 64, 1), (2, 16, 8, 128, 8192), (4, 32, 8, 32, 1088),
    (3, 14, 2, 40, 77), (2, 8, 8, 192, 1025), (1, 16, 2, 128, 65),
    # G = 16, the tensor-core path's widest, and G = 20 (passes of 8 heads)
    (1, 32, 2, 64, 300), (1, 40, 2, 64, 100),
])
def test_decode_attention_kernel_matches_plain(cuda_device, dtype, b, h,
                                               kvh, hd, t):
    rng = np.random.default_rng(b * h + t)
    q = _randn(rng, (b, h, hd), dtype, cuda_device)
    k = _randn(rng, (b, t, kvh, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kvh, hd), dtype, cuda_device)
    valid = torch.from_numpy(rng.random((b, t)) < 0.8).to(cuda_device)
    valid[0] = False                          # a row with no valid key
    att.reset_launches()
    got = att.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert att.launches["decode_attention"] == 1
    want = att.decode_attention_plain(q, k, v, valid)
    atol, rtol = ATT_TOL[dtype][0]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    # valid as a broadcast view of a (T,) mask
    row = valid[-1]
    got = att.decode_attention(q, k, v, row[None].expand(b, t))
    want = att.decode_attention_plain(q, k, v, row[None].expand(b, t))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


FLASH_CASES = [  # b, s, t, h, kv, hd, hdv, causal, window, cap
    (2, 256, 256, 4, 2, 64, 64, True, 0, 0.0),
    (1, 200, 200, 4, 4, 32, 32, True, 0, 50.0),
    (2, 128, 384, 2, 1, 64, 32, False, 0, 0.0),
    (1, 256, 256, 8, 2, 64, 64, True, 96, 0.0),
    (2, 300, 300, 32, 8, 128, 128, True, 0, 0.0),
    (1, 77, 130, 7, 1, 16, 16, False, 9, 0.0),
    (1, 8, 4, 2, 1, 16, 16, True, 2, 0.0),       # rows with no key
    (1, 65, 65, 2, 2, 256, 256, True, 0, 0.0),
    (1, 70, 90, 4, 4, 192, 128, True, 0, 0.0),   # MLA's head dims
    # S and T off every tile, G in {1, 2, 4, 7, 8}, every head dim of the
    # configs, one through the padding (40), masks at the tiles' edges
    (1, 1, 1, 8, 8, 64, 64, True, 0, 0.0),
    (1, 65, 65, 8, 4, 32, 32, True, 0, 0.0),
    (2, 1025, 1025, 8, 1, 128, 128, True, 0, 0.0),
    (1, 300, 1025, 14, 2, 40, 40, False, 0, 0.0),
    (1, 65, 300, 4, 1, 96, 96, True, 64, 30.0),
    (1, 1025, 1025, 16, 8, 128, 128, True, 256, 0.0),
    (1, 12, 6, 8, 1, 128, 128, True, 3, 0.0),     # rows with no key
    (2, 300, 65, 4, 4, 40, 24, False, 17, 20.0),
    # deepseek-v2-lite's MLA prefill (16 heads, hd 192, hdv 128), a
    # decode step's cross-attention (S = 1, non-causal, T = 16), and
    # gemma2's soft-capped local and global layers (G 2, hd 256)
    (2, 130, 130, 16, 16, 192, 128, True, 0, 0.0),
    (2, 1, 16, 16, 16, 64, 64, False, 0, 0.0),
    (1, 96, 96, 16, 8, 256, 256, True, 64, 50.0),
    (1, 96, 96, 16, 8, 256, 256, True, 0, 50.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,hdv,causal,window,cap", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, b, s, t,
                                              h, kv, hd, hdv, causal, window,
                                              cap):
    rng = np.random.default_rng(s * h + t)
    q = _randn(rng, (b, s, h, hd), dtype, cuda_device)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kv, hdv), dtype, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    att.reset_launches()
    got = att.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert att.launches["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (b, s, h, hdv)
    atol, rtol = ATT_TOL[dtype][1]
    torch.testing.assert_close(got, att.flash_attention_plain(q, k, v, **kw),
                               rtol=rtol, atol=atol)


# the forward's base-2 log-sum-exp against the plain one, absolute: f32
# a few ulps of |lse| ~ 10-80; bf16 inputs are exact in f32, but the
# tensor cores sum the products in another order
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,hdv,causal,window,cap", FLASH_CASES)
def test_flash_forward_lse_matches_plain(cuda_device, dtype, b, s, t, h, kv,
                                         hd, hdv, causal, window, cap):
    """The log-sum-exp the forward kernels keep for the backward, against
    ``torch.logsumexp`` of the plain masked logits (rows with no valid
    key excluded: the backward never reads theirs), and the same output
    as the forward without it."""
    rng = np.random.default_rng(s * h + t)
    q = _randn(rng, (b, s, h, hd), dtype, cuda_device)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kv, hdv), dtype, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    att.reset_launches()
    out, lse = att.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert att.launches["flash_attention"] == 1
    assert lse.dtype == torch.float32 and lse.shape == (b, s, h)
    assert torch.equal(out, att.flash_attention(q, k, v, **kw))
    want = att.flash_lse_plain(q, k, **kw)
    keyed = want > -1e30
    assert bool(keyed.any())
    torch.testing.assert_close(lse[keyed], want[keyed], rtol=0,
                               atol=LSE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 7])
def test_decode_attention_soft_cap_matches_plain(cuda_device, dtype, hd, g):
    """The decode kernel's soft cap (after the scale, before the mask) on
    both designs: bf16 with hd a multiple of 64 runs on the tensor cores,
    the rest on the CUDA cores.  Logits are made large so the cap bites."""
    b, kvh, t = 3, 2, 529
    rng = np.random.default_rng(hd * g)
    q = 4 * _randn(rng, (b, kvh * g, hd), dtype, cuda_device)
    k = 4 * _randn(rng, (b, t, kvh, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kvh, hd), dtype, cuda_device)
    valid = torch.from_numpy(rng.random((b, t)) < 0.8).to(cuda_device)
    valid[0] = False                          # a row with no valid key
    atol, rtol = ATT_TOL[dtype][0]
    for cap in (50.0, 5.0):
        att.reset_launches()
        got = att.decode_attention(q, k, v, valid, softcap=cap)
        torch.cuda.synchronize()
        assert att.launches["decode_attention"] == 1
        want = att.decode_attention_plain(q, k, v, valid, softcap=cap)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert float((got - att.decode_attention_plain(q, k, v, valid)
                  ).abs().max()) > 10 * atol


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b",
                                  "mamba2-780m", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium", "gemma2-9b",
                                  "qwen2-vl-7b"])
def test_every_family_on_the_card_matches_the_cpu(cuda_device, arch):
    """Each new family's reduced config through the kernels on the card
    against the plain versions on the CPU: forward, prefill and 4
    teacher-forced decode steps, logits within 1e-4, the same greedy
    tokens; the card's attention calls launch kernels."""
    cfg = configs.get(arch).reduced()
    tree = seeded_numpy_params(cfg, 0)
    models = [LM(cfg, device=d) for d in (cuda_device, "cpu")]
    for m in models:
        params_from_numpy(m, tree)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))}
    if cfg.is_encdec:
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 5, cfg.d_model), np.float32))
    teacher = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2)
                                            ).astype(np.int32))
    att.reset_launches()
    outs = []
    for m in models:
        b = {k: v.to(m.device) for k, v in batch.items()}
        rows = [m(b).cpu()[:, -1]]
        logits, caches = m.prefill(b, m.init_caches(2, 16))
        rows.append(logits.cpu())
        for t, tok in enumerate(teacher):
            logits, caches = m.decode_step(tok.to(m.device), caches, 12 + t)
            rows.append(logits.cpu())
        outs.append(torch.stack(rows))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))
    has_attn = any(s.mixer == "attn" for s in models[0].specs)
    assert any(att.launches.values()) == has_attn        # the card's
    assert any(att.plain_runs.values()) == has_attn      # the CPU twin's


@pytest.mark.gpu
def test_attention_kernels_launch_nothing_on_empty_batches(cuda_device):
    att.reset_launches()
    q = torch.zeros((0, 8, 64), device=cuda_device)
    k = torch.zeros((0, 16, 2, 64), device=cuda_device)
    valid = torch.zeros((0, 16), dtype=torch.bool, device=cuda_device)
    assert att.decode_attention(q, k, k, valid).shape == (0, 8, 64)
    q4 = torch.zeros((0, 5, 8, 64), device=cuda_device)
    assert att.flash_attention(q4, k, k).shape == (0, 5, 8, 64)
    q4 = torch.zeros((2, 0, 8, 64), device=cuda_device)
    k2 = torch.zeros((2, 16, 2, 64), device=cuda_device)
    assert att.flash_attention(q4, k2, k2).shape == (2, 0, 8, 64)
    assert set(att.launches.values()) == {0}
    assert set(att.plain_runs.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("local", [False, True])
def test_lm_on_the_card_matches_the_cpu(cuda_device, local):
    """The reduced qwen3 (and a LOCAL-window variant) through both
    attention kernels on the card against the plain versions on the CPU:
    prefill and 6 decode steps, logits within 1e-4, same greedy tokens."""
    import dataclasses
    cfg = configs.get("qwen3-4b").reduced()
    if local:
        cfg = dataclasses.replace(cfg, block_pattern=(configs.LOCAL,
                                                      configs.GLOBAL),
                                  num_layers=2, window=8)
    tree = seeded_numpy_params(cfg, 0)
    models = [LM(cfg, device=d) for d in (cuda_device, "cpu")]
    for m in models:
        params_from_numpy(m, tree)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    att.reset_launches()
    outs = []
    for m in models:
        caches = m.init_caches(2, 24)
        logits, caches = m.prefill({"tokens": tokens}, caches)
        rows, cur = [logits.cpu()], logits.argmax(-1).to(torch.int32)
        for t in range(6):
            logits, caches = m.decode_step(cur, caches, 12 + t)
            rows.append(logits.cpu())
            cur = logits.argmax(-1).to(torch.int32)
        outs.append(torch.stack(rows))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))
    n = len(models[0].layers)
    assert att.launches == {"flash_attention": n, "decode_attention": 6 * n,
                            "flash_attention_backward": 0}


# (atol, rtol) of the flash backward by input dtype: f32 the forward's
# bound; bf16 from the card's measured error (7.8e-3 of |plain| at the
# serving shape) with twice the room, under the reference's 3e-2
BWD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-3, 1.6e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,hdv,causal,window,cap", [
    # two small shapes an option: causal with G in {2, 8}, a window, the
    # soft cap, non-causal (cross-attention, one query), hdv != hd (MLA's
    # 192/128, and 40/24 through the padding), rows with no key
    (2, 64, 64, 4, 2, 64, 64, True, 0, 0.0),
    (1, 130, 130, 8, 1, 32, 32, True, 0, 0.0),
    (1, 100, 100, 4, 4, 64, 64, True, 16, 0.0),
    (2, 70, 70, 8, 2, 128, 128, True, 33, 0.0),
    (1, 80, 80, 4, 2, 64, 64, True, 0, 5.0),
    (1, 65, 65, 16, 8, 256, 256, True, 0, 50.0),
    (2, 40, 90, 4, 2, 64, 64, False, 0, 0.0),
    (1, 1, 16, 16, 16, 64, 64, False, 0, 0.0),
    (1, 70, 70, 4, 4, 192, 128, True, 0, 0.0),
    (2, 33, 33, 4, 2, 40, 24, True, 0, 0.0),
    (1, 12, 6, 8, 1, 128, 128, True, 3, 0.0),
    (1, 8, 4, 2, 1, 16, 16, True, 2, 0.0),
    # the tiles' edges: S and T one past a tile with G = 16, G = 64 (one
    # or two positions a dQ block), D = 256 with G = 64 and with a window
    # and the cap (bf16: the dK/dV kernel's split columns), the training
    # shape (the short-sequence key tile) and enough blocks for the long
    # tiles (f32 64 keys, bf16 two warpgroups a block; MLA's head dims)
    (2, 65, 129, 16, 1, 64, 64, False, 0, 0.0),
    (1, 129, 65, 64, 1, 128, 128, True, 0, 0.0),
    (1, 33, 33, 64, 1, 256, 256, True, 0, 0.0),
    (1, 200, 200, 8, 8, 256, 256, True, 64, 30.0),
    (8, 128, 128, 32, 8, 128, 128, True, 0, 0.0),
    (8, 640, 640, 16, 8, 64, 64, True, 0, 0.0),
    (8, 256, 256, 16, 16, 192, 128, True, 0, 0.0),   # f32 D = 192, 64 keys
])
def test_flash_attention_backward_kernel_matches_plain(
        cuda_device, dtype, b, s, t, h, kv, hd, hdv, causal, window, cap):
    rng = np.random.default_rng(s * h + t + hd)
    scale = 3.0 if cap else 1.0            # logits the cap bends
    q = scale * _randn(rng, (b, s, h, hd), dtype, cuda_device)
    k = scale * _randn(rng, (b, t, kv, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kv, hdv), dtype, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = att.flash_attention_with_lse(q, k, v, **kw)
    do = _randn(rng, (b, s, h, hdv), dtype, cuda_device)
    att.reset_launches()
    got = att.flash_attention_backward(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert att.launches["flash_attention_backward"] == 1
    want = att.flash_attention_backward_plain(q, k, v, o, do, **kw)
    atol, rtol = BWD_TOL[dtype]
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(cuda_device, dtype):
    """Two backward calls on the same inputs give the same dq, dk and dv
    bit for bit (no atomics)."""
    rng = np.random.default_rng(11)
    q = _randn(rng, (2, 300, 16, 128), dtype, cuda_device)
    k = _randn(rng, (2, 300, 4, 128), dtype, cuda_device)
    v = _randn(rng, (2, 300, 4, 128), dtype, cuda_device)
    o, lse = att.flash_attention_with_lse(q, k, v)
    do = _randn(rng, tuple(o.shape), dtype, cuda_device)
    first = att.flash_attention_backward(q, k, v, o, do, lse)
    second = att.flash_attention_backward(q, k, v, o, do, lse)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_flash_attention_backward_needs_the_lse_on_the_card(cuda_device):
    q = torch.randn(1, 8, 2, 16, device=cuda_device)
    att.reset_launches()
    with pytest.raises(ValueError, match="log-sum-exp"):
        att.flash_attention_backward(q, q, q, q, q)
    assert att.launches["flash_attention_backward"] == 0


@pytest.mark.gpu
def test_flash_attention_autograd_launches_the_backward_kernel(
        cuda_device, monkeypatch):
    """Gradients through ``flash_attention`` on the card come from the
    backward kernel (no plain version), which reads the log-sum-exp the
    forward kept, and equal autograd through the plain forward."""
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, sh, torch.float32, cuda_device)
               for sh in ((2, 48, 8, 64), (2, 48, 2, 64), (2, 48, 2, 64)))
    do = _randn(rng, (2, 48, 8, 64), torch.float32, cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    seen = []
    backward = att.flash_attention_backward

    def spy(*args, **kw):
        seen.append(args[5])
        return backward(*args, **kw)
    monkeypatch.setattr(att, "flash_attention_backward", spy)
    att.reset_launches()
    got = torch.autograd.grad(att.flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert att.launches["flash_attention"] == 1
    assert att.launches["flash_attention_backward"] == 1
    assert not any(att.plain_runs.values())
    (lse,) = seen
    torch.testing.assert_close(lse, att.flash_lse_plain(q, k), rtol=0,
                               atol=LSE_TOL[torch.float32])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(att.flash_attention_plain(*leaves), leaves,
                               do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


# a context-parallel rank's block of query rows against all T keys: the
# rows [a, a + n) of a call with q_start = a, each case at 3 offsets
Q_START_CASES = [  # b, s, t, h, kv, hd, causal, window, cap
    (1, 192, 192, 4, 2, 64, True, 0, 0.0),
    (2, 99, 99, 8, 1, 128, True, 0, 0.0),
    (1, 150, 150, 4, 4, 64, True, 40, 0.0),
    (1, 96, 96, 8, 2, 128, True, 0, 30.0),
    (1, 144, 144, 28, 4, 128, True, 0, 0.0),     # qwen2-vl's heads
]


def _q_start_blocks(s: int):
    n = s // 3
    return [(0, n), (n, 2 * n), (2 * n, s)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", Q_START_CASES)
def test_flash_attention_q_start_matches_plain(cuda_device, dtype, b, s, t,
                                               h, kv, hd, causal, window,
                                               cap):
    """The forward with a query offset against its plain version, and
    its log-sum-exp; the blocks launch the same kernel as a call
    without one."""
    rng = np.random.default_rng(s * h + t + 1)
    q = _randn(rng, (b, s, h, hd), dtype, cuda_device)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    atol, rtol = ATT_TOL[dtype][1]
    for a, e in _q_start_blocks(s):
        qb = q[:, a:e].contiguous()
        att.reset_launches()
        out, lse = att.flash_attention_with_lse(qb, k, v, q_start=a, **kw)
        torch.cuda.synchronize()
        assert att.launches["flash_attention"] == 1
        assert att.launches["flash_attention_q_start"] == int(a > 0)
        torch.testing.assert_close(
            out, att.flash_attention_plain(qb, k, v, q_start=a, **kw),
            rtol=rtol, atol=atol)
        want = att.flash_lse_plain(qb, k, q_start=a, **kw)
        torch.testing.assert_close(lse, want, rtol=0, atol=LSE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", Q_START_CASES)
def test_flash_attention_backward_q_start_matches_plain(
        cuda_device, dtype, b, s, t, h, kv, hd, causal, window, cap):
    rng = np.random.default_rng(s * h + t + 2)
    q = _randn(rng, (b, s, h, hd), dtype, cuda_device)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda_device)
    do = _randn(rng, (b, s, h, hd), dtype, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    atol, rtol = BWD_TOL[dtype]
    for a, e in _q_start_blocks(s):
        qb, dob = q[:, a:e].contiguous(), do[:, a:e].contiguous()
        o, lse = att.flash_attention_with_lse(qb, k, v, q_start=a, **kw)
        att.reset_launches()
        got = att.flash_attention_backward(qb, k, v, o, dob, lse,
                                           q_start=a, **kw)
        torch.cuda.synchronize()
        assert att.launches["flash_attention_backward"] == 1
        want = att.flash_attention_backward_plain(qb, k, v, o, dob,
                                                  q_start=a, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,hd,t,cap", [
    (8, 32, 8, 128, 2048, 0.0), (2, 16, 8, 256, 300, 50.0),
    (1, 28, 4, 128, 1000, 0.0), (3, 8, 2, 64, 77, 0.0)])
def test_decode_attention_with_lse_matches_plain(cuda_device, dtype, b, h,
                                                 kvh, hd, t, cap):
    """Each half of T against the plain version with its log-sum-exp,
    the halves combined against the whole call, and the output equal to
    the call without the log-sum-exp (one half has no valid key in row
    0)."""
    rng = np.random.default_rng(b * h + t + 3)
    q = _randn(rng, (b, h, hd), dtype, cuda_device)
    k = _randn(rng, (b, t, kvh, hd), dtype, cuda_device)
    v = _randn(rng, (b, t, kvh, hd), dtype, cuda_device)
    valid = torch.from_numpy(rng.random((b, t)) < 0.8).to(cuda_device)
    half = t // 2
    valid[0, half:] = False
    atol, rtol = ATT_TOL[dtype][0]
    outs, lses = [], []
    for a, e in ((0, half), (half, t)):
        kb, vb = k[:, a:e].contiguous(), v[:, a:e].contiguous()
        vd = valid[:, a:e].contiguous()
        att.reset_launches()
        out, lse = att.decode_attention_with_lse(q, kb, vb, vd, softcap=cap)
        torch.cuda.synchronize()
        assert att.launches["decode_attention_with_lse"] == 1
        assert att.launches["decode_attention"] == 0
        assert torch.equal(out, att.decode_attention(q, kb, vb, vd,
                                                     softcap=cap))
        w_out, w_lse = att.decode_attention_plain(q, kb, vb, vd, softcap=cap,
                                                  with_lse=True)
        torch.testing.assert_close(out, w_out, rtol=rtol, atol=atol)
        keyed = w_lse > -1e30
        torch.testing.assert_close(lse[keyed], w_lse[keyed], rtol=0,
                                   atol=LSE_TOL[dtype])
        outs.append(out)
        lses.append(lse)
    got = att.combine_decode(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(
        got, att.decode_attention_plain(q, k, v, valid, softcap=cap),
        rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_decode_attention_raises_when_an_input_requires_grad(cuda_device):
    q = torch.randn(2, 8, 64, device=cuda_device, requires_grad=True)
    k = torch.randn(2, 16, 2, 64, device=cuda_device)
    valid = torch.ones((2, 16), dtype=torch.bool, device=cuda_device)
    att.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        att.decode_attention(q, k, k, valid)
    assert att.launches["decode_attention"] == 0
    with torch.no_grad():
        assert att.decode_attention(q, k, k, valid).shape == (2, 8, 64)


# ------------------------------------------- the online runtime on the card

def _online_cfgs(n_cache_old=36, n_cache_new=20):
    from repro_torch.core import cache_sim as cs
    spec = cs.SYSTEMS["Morpheus-ALL"]
    return cs.build_config(spec, n_cache_old), cs.build_config(spec,
                                                               n_cache_new)


def _cfd_trace(length, seed=0):
    from repro_torch.core import cache_sim as cs
    from repro_torch.core import traces as tr
    return tr.generate("cfd", n_cores=32, length=length, seed=seed,
                       ws_scale=1.0 / cs.SIM_SCALE)


@pytest.mark.gpu
@pytest.mark.parametrize("migrate", [True, False])
def test_stateful_scans_on_a_handed_off_state(cuda_device, migrate):
    """A warmed-up state handed off to another split (rows rebuilt on the
    host: lru = LRU_MAX_INT - k, sizes carried, one way a tag) passes the
    row contract, and the next epoch through both stateful scans on the
    card equals their plain versions on the same rows."""
    from repro_torch.runtime import stream
    old, new = _online_cfgs()
    a, w, l = _cfd_trace(12_000)
    state = engine.init_state(old, 1, device=cuda_device)
    state, _ = engine.advance_packed(
        old, engine.pack(old, [(a[:9000], w[:9000], l[:9000], 0)]), state,
        device=cuda_device)
    state, rep = stream.handoff(old, state, new, migrate=migrate)
    assert rep.resident_before > 0 and (rep.migrated > 0) == migrate
    pt = engine.to_device(engine.pack(
        new, [(a[9000:], w[9000:], l[9000:], 0)], pos0=[9000]), cuda_device)
    warm = pt.warmup[:, None, None]
    crows = ctl.ConvRow(*[getattr(state, f) for f in engine._CONV_FIELDS])
    erows = ctl.ExtRow(*[getattr(state, f) for f in engine._EXT_FIELDS])
    cargs = (new, pt.conv_tag, pt.conv_write, pt.conv_active,
             pt.conv_active & (pt.conv_pos >= warm))
    eargs = (new, pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active,
             pt.ext_active & (pt.ext_pos >= warm))
    scan.reset_launches()
    _close(scan.conv_scan(*cargs, state=crows, keep_state=True),
           scan.conv_scan_plain(*cargs, state=crows, keep_state=True),
           f"conv after handoff migrate={migrate}")
    _close(scan.ext_scan(*eargs, state=erows, keep_state=True),
           scan.ext_scan_plain(*eargs, state=erows, keep_state=True),
           f"ext after handoff migrate={migrate}")
    assert scan.launches == {"conv_scan": 1, "ext_scan": 1}


def _online_summary(r):
    return ([(d.epoch, d.trigger, d.from_split, d.to_split,
              d.flush_writebacks) for d in r.decisions],
            [(x.n_compute, x.n_cache) for x in r.records],
            {f: int(np.asarray(getattr(r.stats, f)))
             for f in ctl._INT_FIELDS})


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["phased", "tenants"])
def test_simulate_online_on_the_card_matches_the_cpu(cuda_device, form):
    """A short governed run on the card (the stateful scans once an epoch,
    handoffs between) against the same run on the CPU: identical
    decisions, splits and integer Stats; per-tenant sums equal the
    global ones."""
    from repro_torch.runtime import governor as gov
    from repro_torch.workloads.serving import bursty_workload
    grid = (18, 32, 48, 68)
    if form == "phased":
        cands = gov.candidates_for("kmeans", "Morpheus-ALL", grid=grid,
                                   length=24_000)
        runs = [gov.simulate_online(("kmeans", "lib"), "Morpheus-ALL",
                                    length=24_000, epoch_len=1_500,
                                    candidates=cands, device=d)
                for d in (cuda_device, "cpu")]
    else:
        wl = bursty_workload("cfd,kmeans", "mmpp:4e5,6e6,2e-3,6e-4",
                             length=12_000)
        cands = gov.candidates_for(wl.primary_app, "Morpheus-ALL",
                                   grid=grid, length=12_000)
        runs = [gov.simulate_online(wl, "Morpheus-ALL", target_epoch=1_500,
                                    candidates=cands, gcfg=gov.SERVING_GCFG,
                                    device=d)
                for d in (cuda_device, "cpu")]
    card, cpu = runs
    assert _online_summary(card) == _online_summary(cpu)
    assert card.switches > 0
    if form == "tenants":
        for f in ctl._INT_FIELDS:
            assert sum(int(getattr(s, f)) for s in
                       card.tenant_stats.values()) == \
                int(getattr(card.stats, f)), f


@pytest.mark.gpu
def test_epoch_stream_ring_matches_no_ring_on_the_card(cuda_device):
    """Epochs parked on the card by the ring (pinned copies on a side
    stream, ordered by an event) give the Stats and rows of the plain
    stream; a snapshot taken mid-run resumes identically."""
    from repro_torch.runtime import stream
    cfg, _ = _online_cfgs()
    a, w, l = _cfd_trace(24_000, seed=2)
    runs = {}
    for ring in (0, 2):
        s = stream.EpochStream(cfg, a, w, l, epoch_len=3_000, ring=ring,
                               device=cuda_device)
        deltas = [s.step() for _ in range(3)]
        snap = s.snapshot()
        deltas += [s.step() for _ in range(5)]
        assert s.done
        runs[ring] = (deltas, s.state, snap)
    for d0, d2 in zip(runs[0][0], runs[2][0]):
        for x, y in zip(d0, d2):
            assert torch.equal(x, y)
    for x, y in zip(runs[0][1].stats, runs[2][1].stats):
        assert torch.equal(x, y)
    for x, y in zip(runs[0][1][:-2], runs[2][1][:-2]):
        assert torch.equal(x, y)
    again = stream.EpochStream(cfg, a, w, l, epoch_len=3_000, ring=2,
                               device=cuda_device)
    again.restore(runs[2][2])
    again.run()
    for x, y in zip(runs[0][1].stats, again.state.stats):
        assert torch.equal(x, y)


def _fleet_record(r):
    return (_online_summary(r), r.switches,
            [float(x.reward) for x in r.records], float(r.ipc))


@pytest.mark.gpu
def test_fleet_on_the_card_equals_its_serial_loop(cuda_device):
    """A 4-replica fleet on the card (one stateful scan launch a group
    epoch) against ``run_serial`` on the card: decisions, splits and
    integer Stats identical, ``ipc`` and every reward within 1e-9
    relative (tests/test_fleet.py's bound); the scans launched once a
    group epoch and the plain versions never."""
    from repro_torch.runtime import fleet
    cands = [(18, 50), (32, 36), (48, 20), (68, 0)]
    specs = [fleet.ReplicaSpec(app, "Morpheus-ALL", length=12_000,
                               epoch_len=2_000, seed=s, candidates=cands)
             for s, app in enumerate(("cfd", "stencil", "p-bfs", "kmeans"))]
    scan.reset_launches()
    fr = fleet.simulate_fleet(specs, device=cuda_device)
    assert scan.launches["conv_scan"] == fr.dispatches
    assert scan.plain_runs == {"conv_scan": 0, "ext_scan": 0}
    serial = fleet.run_serial(specs, device=cuda_device)
    for i, (a, b) in enumerate(zip(serial, fr.results)):
        (sa, wa, ra, ia), (sb, wb, rb, ib) = _fleet_record(a), \
            _fleet_record(b)
        assert (sa, wa) == (sb, wb), f"replica {i}"
        for x, y in zip(ra + [ia], rb + [ib]):
            assert abs(x - y) <= 1e-9 * max(abs(x), 1.0), f"replica {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 3, 64])
def test_row_float_sums_do_not_depend_on_the_batch(cuda_device, rows):
    """A row's float Stats, summed over its sets on the card, are the same
    bits whatever rows are batched around it (the fleet's 1e-9 identity
    rests on it)."""
    cfg = _cfg()
    tr = _traces(seed=5)
    alone = engine.simulate_batch(cfg, tr[:1], device=cuda_device)
    batch = engine.simulate_batch(cfg, (tr * rows)[:rows] if rows > 1
                                  else tr[:1], device=cuda_device)
    for f in ctl.Stats._fields:
        x = getattr(alone, f)[0]
        assert torch.equal(x, getattr(batch, f)[0]), f
    fv = torch.rand((rows, 333, 7), device=cuda_device)
    one = engine._set_sum(fv[:1].contiguous())
    assert torch.equal(engine._set_sum(fv)[:1], one)


@pytest.mark.gpu
def test_overload_masked_rows_sum_to_the_global_stats(cuda_device):
    """``simulate_overload`` on the card: one count-masked row a tenant a
    round; the tenants' integer hit and miss counters sum to the global
    run's, and the run equals the CPU's."""
    from repro_torch.runtime import admission
    from repro_torch.workloads import overload, serving
    tenants = [serving.TenantSLO("a", 4.0, weight=2.0, priority=1,
                                 app="cfd"),
               serving.TenantSLO("b", 8.0, weight=1.0, priority=0,
                                 app="kmeans"),
               serving.TenantSLO("c", 16.0, weight=1.0, priority=0,
                                 app="histo")]
    sched = overload.demand_schedule(overload.LoadScenario(
        "s", "sustained", 4.0, rounds=8), tenants, 24)
    def run(device):
        return admission.simulate_overload(tenants, sched,
                                           candidates=[(32, 36), (48, 20)],
                                           max_total=32, seed=2,
                                           device=device)
    scan.reset_launches()
    card = run(cuda_device)
    assert scan.launches["conv_scan"] == sum(
        1 for r in card.rounds if not r.get("idle"))
    cpu = run("cpu")
    assert card.attribution_exact() and sum(card.shed.values()) > 0
    ints = {f: int(np.asarray(getattr(card.stats, f)))
            for f in ctl._INT_FIELDS}
    assert ints == {f: int(np.asarray(getattr(cpu.stats, f)))
                    for f in ctl._INT_FIELDS}
    assert [r["served"] for r in card.rounds] == \
        [r["served"] for r in cpu.rounds]
    assert [d.compact() for d in card.decisions] == \
        [d.compact() for d in cpu.decisions]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_wrappers_charge_their_meta_count(cuda_device, dtype):
    """Each attention wrapper on the card charges the op counter exactly
    what it charges on ``meta`` (its ``kernel_work`` formula, nothing
    else), launching its kernel there and nothing on ``meta``."""
    from repro_torch.roofline import op_cost
    rng = np.random.default_rng(5)

    def randn(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            cuda_device, dtype)

    q, k, v = randn((2, 96, 8, 64)), randn((2, 96, 2, 64)), randn((2, 96, 2,
                                                                    32))
    valid = torch.from_numpy(rng.random((2, 80)) < 0.7).to(cuda_device)
    qd, kd = randn((2, 8, 64)), randn((2, 80, 2, 64))
    n_valid = int(valid.sum())
    out, lse = att.flash_attention_with_lse(q, k, v, window=16)
    calls = {
        "flash_attention": lambda x: att.flash_attention(
            x["q"], x["k"], x["v"], window=16),
        "decode_attention": lambda x: att.decode_attention(
            x["qd"], x["kd"], x["kd"], x["valid"], valid_count=n_valid),
        "flash_attention_backward": lambda x: att.flash_attention_backward(
            x["q"], x["k"], x["v"], x["out"], x["out"], x["lse"],
            window=16)}
    card = dict(q=q, k=k, v=v, qd=qd, kd=kd, valid=valid, out=out, lse=lse)
    meta = {n: torch.empty_like(t, device="meta") for n, t in card.items()}
    for name, call in calls.items():
        att.reset_launches()
        got = op_cost.analyze(call, card)
        assert att.launches[name] == 1, name
        want = op_cost.analyze(call, meta)
        assert att.launches[name] == 1 and not any(att.plain_runs.values())
        assert got.by_name == want.by_name == {
            name: [1, want.flops, want.bytes]}, name
        assert got.flops > 0 and got.bytes > 0
