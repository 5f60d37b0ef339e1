"""The port's numpy pieces are byte-identical to the reference: the
Table-2 trace generators (golden crc of tests/test_workloads.py) and the
engine's ``pack``, including the edge cases of tests/test_engine.py."""
import zlib

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.workloads import synthetic as j_syn  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.workloads import synthetic as t_syn  # noqa: E402


def test_synthetic_golden_crc():
    a, w, l = t_syn.generate("cfd", n_cores=8, length=4000, seed=3,
                             ws_scale=0.125)
    assert (zlib.crc32(a.tobytes()), zlib.crc32(w.tobytes()),
            zlib.crc32(l.tobytes())) == (1118088029, 821650521, 862733448)


@pytest.mark.parametrize("app", ["cfd", "kmeans", "histo", "mri-gri",
                                 "stencil", "dwt2d", "lib"])
def test_synthetic_arrays_identical(app):
    kw = dict(n_cores=12, length=3000, seed=5, ws_scale=0.125)
    for ref, got in zip(j_syn.generate(app, **kw), t_syn.generate(app, **kw)):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)
    ph = dict(n_cores=4, length=2000, seed=1)
    for ref, got in zip(j_syn.generate_phased(("kmeans", "lib"), **ph),
                        t_traces.generate_phased(("kmeans", "lib"), **ph)):
        np.testing.assert_array_equal(ref, got)


def _assert_pack_equal(cfg, pcfg, traces, **kw):
    ref = j_engine.pack(cfg, traces, **kw)
    got = t_engine.pack(pcfg, traces, **kw)
    for name, r, g in zip(ref._fields, ref, got):
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
    return got


def test_pack_identical_random_batch():
    cfg, pcfg = tp.small_cfg()
    traces = [(*tp.trace(n=n, seed=s), w)
              for n, s, w in ((500, 1, 0), (731, 2, 100), (64, 3, 64))]
    _assert_pack_equal(cfg, pcfg, traces)
    count = [np.arange(len(t[0])) % 3 != 0 for t in traces]
    _assert_pack_equal(cfg, pcfg, traces, pos0=[0, 500, 7], count=count)


def test_pack_edge_cases_identical():
    cfg, pcfg = tp.small_cfg()
    total = cfg.amap.total_sets
    empty = (np.zeros(0, np.uint32), np.zeros(0, bool), np.zeros(0, np.int32))
    pt = _assert_pack_equal(cfg, pcfg, [(*empty, 0)])
    assert pt.conv_tag.shape[2] == 0 and pt.ext_tag.shape[2] == 0
    one_set = (np.arange(100, dtype=np.uint32) * total + 2,
               np.zeros(100, bool), np.zeros(100, np.int32), 0)
    pt = _assert_pack_equal(cfg, pcfg, [one_set])
    assert pt.conv_active[0, 2].sum() == 100 and pt.ext_tag.shape[2] == 0
    for n, expect in ((15, 16), (16, 16), (17, 32), (64, 64), (65, 128)):
        t = (np.arange(n, dtype=np.uint32) * total, np.zeros(n, bool),
             np.zeros(n, np.int32), 0)
        assert _assert_pack_equal(cfg, pcfg, [t]).conv_tag.shape[2] == expect
    cfg, pcfg = tp.small_cfg(chips=0, sets_per_chip=0)     # conv only
    _assert_pack_equal(cfg, pcfg, [(*tp.trace(seed=9), 0)])
