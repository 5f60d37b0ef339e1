"""The engine-scan kernels' wrappers (``repro_torch.kernels.engine_scan``):
argument checks on the CPU, and, on a CUDA card only (marker ``gpu``),
each CUDA kernel against its plain PyTorch version.  This file imports no
JAX, so it runs on a card host that has none:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import address_separation as asep  # noqa: E402
from repro_torch.core import controller as ctl  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import engine_scan as scan  # noqa: E402


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


# ---------------------------------------------------- on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
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
