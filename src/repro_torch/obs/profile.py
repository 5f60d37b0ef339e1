"""Stream profiling: exact reuse-distance histograms + working-set
curves (a copy of ``repro.obs.profile``).

Host-side numpy over a raw address trace — no engine involvement, so the
profile is exact by construction and usable offline (a corpus file) or
online (the slice an ``EpochStream`` is about to replay).  The core
invariant every product satisfies: **histogram mass equals the request
count** — every access lands either in a reuse-distance bin or in the
cold-miss bin (first touch), never both, never neither
(tests/test_obs.py).

Reuse distance here is the standard stack distance: the number of
*distinct* block addresses touched since the previous access to the same
block (cold misses carry distance −1).  Computed exactly in
O(N log N) with a Fenwick tree over last-occurrence positions.

Import-pure like the rest of ``obs``: numpy only.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

COLD = -1       # reuse distance of a first touch


def reuse_distances(addrs) -> np.ndarray:
    """Exact per-access stack distances (int64; ``COLD`` on first touch).

    Fenwick tree over positions: position *i* holds 1 iff it is the
    current last occurrence of its address, so the number of distinct
    addresses between two accesses to the same block is a range sum.
    """
    addrs = np.asarray(addrs)
    n = len(addrs)
    out = np.empty(n, np.int64)
    bit = np.zeros(n + 1, np.int64)

    def update(i: int, v: int) -> None:
        i += 1
        while i <= n:
            bit[i] += v
            i += i & (-i)

    def prefix(i: int) -> int:      # sum of positions [0, i]
        i += 1
        s = 0
        while i > 0:
            s += bit[i]
            i -= i & (-i)
        return s

    last: Dict[int, int] = {}
    for i in range(n):
        a = int(addrs[i])
        j = last.get(a)
        if j is None:
            out[i] = COLD
        else:
            # distinct addresses strictly between j and i
            out[i] = prefix(i - 1) - prefix(j)
            update(j, -1)
        update(i, 1)
        last[a] = i
    return out


def reuse_histogram(addrs) -> Dict:
    """Exact reuse-distance histogram with power-of-two bins.

    Returns ``{"cold", "bins", "bin_edges", "mass"}`` where ``bins[k]``
    counts accesses with distance in ``[2^(k-1), 2^k)`` (``bins[0]`` is
    distance 0, i.e. consecutive re-touch of the hottest block) and
    ``mass == cold + sum(bins) == len(addrs)``.
    """
    d = reuse_distances(addrs)
    cold = int((d == COLD).sum())
    pos = d[d != COLD]
    if len(pos):
        # distance 0 -> bin 0; distance d>0 -> bin 1+floor(log2(d))
        idx = np.where(pos == 0, 0,
                       np.floor(np.log2(np.maximum(pos, 1))).astype(
                           np.int64) + 1)
        bins = np.bincount(idx).astype(np.int64)
    else:
        bins = np.zeros(0, np.int64)
    edges = [0] + [1 << k for k in range(len(bins))]
    return {"cold": cold, "bins": bins.tolist(),
            "bin_edges": edges[:len(bins) + 1],
            "mass": cold + int(bins.sum())}


def wss_curve(addrs, *, points: int = 32,
              block_bytes: int = 128) -> Dict:
    """Working-set-size curve: distinct blocks (and bytes) touched up to
    each of ``points`` evenly spaced positions along the trace."""
    addrs = np.asarray(addrs)
    n = len(addrs)
    if n == 0:
        return {"positions": [], "distinct_blocks": [], "wss_bytes": [],
                "footprint_blocks": 0}
    first = np.zeros(n, bool)
    _, first_idx = np.unique(addrs, return_index=True)
    first[first_idx] = True
    cum = np.cumsum(first)
    pts = np.unique(np.linspace(1, n, min(points, n)).astype(np.int64))
    return {
        "positions": pts.tolist(),
        "distinct_blocks": cum[pts - 1].tolist(),
        "wss_bytes": (cum[pts - 1] * block_bytes).tolist(),
        "footprint_blocks": int(cum[-1]),
    }


def profile_trace(addrs, *, tenant_id=None,
                  names: Optional[Sequence[str]] = None,
                  block_bytes: int = 128, points: int = 32) -> Dict:
    """Full stream profile: reuse histogram + WSS curve, globally and —
    when ``tenant_id`` labels each access — per tenant.

    Per-tenant profiles run on the tenant's own subsequence (its private
    address stream), so each tenant's mass equals its request count and
    the per-tenant masses sum to the global mass.
    """
    out = {
        "requests": int(len(np.asarray(addrs))),
        "reuse": reuse_histogram(addrs),
        "wss": wss_curve(addrs, points=points, block_bytes=block_bytes),
    }
    if tenant_id is not None:
        tid = np.asarray(tenant_id)
        tenants = {}
        for k in np.unique(tid):
            name = names[int(k)] if names is not None and \
                0 <= int(k) < len(names) else f"t{int(k)}"
            sub = np.asarray(addrs)[tid == k]
            tenants[name] = {
                "requests": int(len(sub)),
                "reuse": reuse_histogram(sub),
                "wss": wss_curve(sub, points=points,
                                 block_bytes=block_bytes),
            }
        out["tenants"] = tenants
    return out
