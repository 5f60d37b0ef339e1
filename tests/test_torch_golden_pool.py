"""Golden results of the reference's serving page pool, kept in
tests/data/torch_golden_pool.json, which the port's chip check
(``chip_smoke.py``) holds the pool on the card to.

Each of three cells replays fixed batches of page keys through
``repro.serving.paged_kv.MorpheusPagePool``: per batch ``lookup_batch``,
then ``write_page`` of ``torch_parity.pool_payload`` for every backing
fetch (tier 2) in plan order, then ``read_pages`` of the plan.  The file
keeps the keys, the final ``PoolStats``, and crc32s of the concatenated
plans (tier, set_idx, way as int32), of the pages read (uint32) and of
the final state (``STATE_FIELDS`` in order, in the reference's dtypes).

This test keeps the file current and replays the port's plain path
(``device="cpu"``) against it.  Regenerate the file with
``PYTHONPATH=src python tests/test_torch_golden_pool.py``.
"""
import json
import sys
import zlib
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, data as numpy)
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import paged_kv as j_kv  # noqa: E402
from repro_torch.serving import paged_kv as t_kv  # noqa: E402
from torch_parity import pool_payload, pool_stream  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_pool.json"
CELLS = [
    ("engine-pool/bloom/compressed",
     dict(conv_sets=64, ext_sets_per_chip=32, ways=4), 3),
    ("defaults/no-predictor/uncompressed",
     dict(predictor="none", compression=False), 3),
    ("no-cache-chips/perfect",
     dict(conv_sets=64, ways=4, num_cache_chips=0, predictor="perfect"), 3),
]


def replay(pool, batches, write, read, state) -> dict:
    """The golden procedure on one pool; ``write(pool, key, payload)``,
    ``read(pool, plan) -> uint32 array`` and ``state(pool) -> {name:
    array}`` adapt it to either package."""
    plans = reads = 0
    for keys in batches:
        keys = np.asarray(keys, np.uint32)
        plan = pool.lookup_batch(keys)
        plans = zlib.crc32(b"".join(np.ascontiguousarray(x, np.int32)
                                    .tobytes() for x in plan), plans)
        for k in keys[plan.tier == 2]:
            write(pool, int(k), pool_payload(int(k), pool.cfg.page_words))
        reads = zlib.crc32(np.ascontiguousarray(read(pool, plan),
                                                np.uint32).tobytes(), reads)
    st = state(pool)
    state_crc = 0
    for name in t_kv.STATE_FIELDS:
        state_crc = zlib.crc32(np.ascontiguousarray(st[name]).tobytes(),
                               state_crc)
    return {"stats": dict(pool.stats._asdict()), "plans_crc": plans,
            "reads_crc": reads, "state_crc": state_crc}


def reference_cells() -> list:
    out = []
    for seed, (name, kw, n) in enumerate(CELLS):
        cfg = j_kv.PoolConfig(**kw)
        batches = [k.tolist() for k in pool_stream(
            cfg.amap.total_sets, cfg.conv_sets, n, seed)]
        res = replay(
            j_kv.MorpheusPagePool(cfg), batches,
            lambda p, k, w: p.write_page(k, jnp.asarray(w)),
            lambda p, plan: np.asarray(p.read_pages(plan)),
            lambda p: {f: np.asarray(getattr(p, f))
                       for f in t_kv.STATE_FIELDS})
        out.append({"name": name, "config": kw, "batches": batches, **res})
    return out


def port_replay(cell: dict, device) -> dict:
    return replay(
        t_kv.MorpheusPagePool(t_kv.PoolConfig(**cell["config"]), device),
        cell["batches"], lambda p, k, w: p.write_page(k, w),
        lambda p, plan: p.read_pages(plan).cpu().numpy().view(np.uint32),
        t_kv.pool_to_numpy)


def test_golden_pool_file_is_current():
    assert json.loads(GOLDEN.read_text())["cells"] == reference_cells()


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_port_plain_path_matches_golden_pool(i):
    cell = json.loads(GOLDEN.read_text())["cells"][i]
    got = port_replay(cell, "cpu")
    assert got == {k: cell[k] for k in got}


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps({
        "source": "repro.serving.paged_kv.MorpheusPagePool (Pallas kernels "
                  "in interpret mode); procedure in tests/"
                  "test_torch_golden_pool.py", "cells": reference_cells()},
        indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
