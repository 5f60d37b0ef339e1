"""Two-tier Morpheus page pool for serving, after
``repro.serving.paged_kv``: the paper's technique as a serving feature.

Pages (KV blocks, MLA latents, or expert/embedding rows) are cached in

  * the **conventional tier**, the compute chips' local page pool (a
    plain set-associative store, no predictor), and
  * the **extended tier**, capacity contributed by cache-mode chips,
    fronted by the double-Bloom hit/miss predictor so that predicted
    misses skip the interconnect round trip (paper Fig. 5/6), with its
    blocks BDI-compressed.

``lookup_batch`` routes a batch of page keys, queries and updates the
predictor and tag stores through the pool kernels (``kernels.ops``:
``lookup_fill``, ``bloom_query``, ``bloom_record``) and returns a
``GatherPlan``; ``write_page`` installs a payload (``page_write``: the
probe, BDI compression on the extended tier and the store write) and
``read_pages`` reads hit pages of both tiers (``read_rows``: the
Indirect-MOV gather, fused with BDI decompression on the extended
tier).

The planning stays numpy on the host, as in the reference; the state
tensors live on the pool's device.  Where the reference gathers filter
rows and data tiles on the host or loops over keys, the port hands the
kernels the whole stores and row indices: one ``bloom_query`` reads the
predictor's filter rows, one ``bloom_record`` records a batch's extended
keys, one ``read_rows`` reads a plan's pages, each after one copy of its
indices to the device.  The conventional tier's per-round lookups, the
extended tier's tag match and the fills still read state rows back to
the host.  ``MorpheusPagePool(cfg)`` runs on the CUDA card and raises
``BackendError`` without one; ``device="cpu"`` runs the kernels' plain
versions.  Where the reference rebuilds an array (``.at[].set``), the
port writes the same elements in place; no caller holds the old arrays,
so the results are the same.

Dtypes: tags, LRU counters, Bloom words, payload words and BDI bases are
int32 tensors holding the uint32 bit pattern, valid bits are bool, BDI
levels and the Bloom MRU counts ``n_mru`` int32.  ``ext_size`` and
``ext_used`` are host numpy arrays, as in the reference (which keeps
``n_mru`` there too).  ``pool_from_numpy``/``pool_to_numpy`` carry a
pool's state from and to the reference's numpy dtypes.

Behaviours of the reference that the port keeps on purpose:

  * each conventional round of ``lookup_batch`` looks up the whole
    conventional store with request tag 0 for the sets outside the round,
    so a set that holds a valid tag-0 page (a key below ``total_sets``)
    "hits" and its LRU row is rewritten;
  * the conventional tier serves at most 4 rounds per batch: a 5th
    request to one set in a batch is counted nowhere and gets tier 2;
  * a key repeated within a batch is looked up once on the extended tier
    but filled once per occurrence, so one set can hold its tag twice;
  * a Bloom record ORs bf1's insert mask into both filters.

With tracing on (``obs.enable()``) ``lookup_batch`` and ``write_page``
are ``pool.lookup`` and ``pool.write`` spans (tags ``keys`` and ``tier``,
the tier the keys route to: 0 conventional, 1 extended, -1 both), and
each read of device state back to the host is a ``pool.readback`` span
(``bytes``): one a conventional lookup, three an extended lookup that
hits and five one that misses (the prediction, the extended tags and
valid bits, the victim's two rows).

``TraceRecorder.save`` writes the recorded events through
``workloads.corpus``; ``MorpheusPagePool.content_snapshot`` decodes the
pool's contents into an ``obs.inspect.Snapshot``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _u32, obs
from ..core import address_separation as asep
from ..core.compression import UNCOMP
from ..core.energy import TPUv5e
from ..core.engine import resolve_device
from ..kernels import ops as K

# TraceRecorder event codes (also the ``levels`` column of a corpus
# export, so they must stay in the corpus-legal {0, 1, 2} range)
EV_LOOKUP, EV_INSERT, EV_EVICT = 0, 1, 2
EVENT_NAMES = ("lookup", "insert", "evict")


class TraceRecorder:
    """Fixed-capacity ring of block-level pool events (lookup / insert /
    evict), recorded as parallel numpy columns.

    Pure logging: attaching a recorder changes no pool decision and no
    stat.  Past capacity the oldest events are overwritten; ``total``
    keeps the true count."""

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.keys = np.zeros(self.capacity, np.uint32)
        self.events = np.zeros(self.capacity, np.int8)
        self.tiers = np.zeros(self.capacity, np.int8)
        self._next = 0
        self._count = 0
        self.total = 0

    def record(self, event: int, keys, tiers) -> None:
        keys = np.atleast_1d(np.asarray(keys, np.uint32))
        tiers = np.broadcast_to(np.asarray(tiers, np.int8), keys.shape)
        for k, t in zip(keys, tiers):
            self.keys[self._next] = k
            self.events[self._next] = event
            self.tiers[self._next] = t
            self._next = (self._next + 1) % self.capacity
        self._count = min(self._count + len(keys), self.capacity)
        self.total += len(keys)

    def __len__(self) -> int:
        return self._count

    def arrays(self):
        """(keys, events, tiers) held in the ring, oldest first."""
        if self._count < self.capacity:
            sl = slice(0, self._count)
            return self.keys[sl], self.events[sl], self.tiers[sl]
        idx = np.r_[self._next:self.capacity, 0:self._next]
        return self.keys[idx], self.events[idx], self.tiers[idx]

    def counts(self) -> Dict[str, int]:
        _, ev, _ = self.arrays()
        return {name: int((ev == code).sum())
                for code, name in enumerate(EVENT_NAMES)}

    def save(self, path, *, name: str = "pool_events"):
        """Write the ring to a trace-corpus ``.npz`` (keys as addresses,
        event codes as levels, mutating events as writes)."""
        from ..workloads import corpus
        keys, ev, tiers = self.arrays()
        assert len(keys) > 0, "recorder is empty"
        return corpus.save_trace(
            path, keys, ev != EV_LOOKUP, ev.astype(np.int32),
            name=name, like="pool_events", n_cores=0, seed=0, ws_scale=1.0,
            extra={"kind": "pool_events",
                   "event_codes": dict(enumerate(EVENT_NAMES)),
                   "column_semantics": {
                       "addrs": "page key", "levels": "event code",
                       "writes": "mutating event (insert/evict)"},
                   "events": self.counts(),
                   "tier_counts": {str(t): int((tiers == t).sum())
                                   for t in np.unique(tiers)},
                   "dropped": max(self.total - self._count, 0)})


@dataclass(frozen=True)
class PoolConfig:
    conv_sets: int = 256
    ext_sets_per_chip: int = 64
    num_cache_chips: int = 4
    ways: int = 8
    page_words: int = 32          # uint32 words per page payload slot
    compression: bool = True
    predictor: str = "bloom"      # bloom | none | perfect
    bloom_words: int = 8          # 32-byte filters (paper)

    @property
    def amap(self) -> asep.AddressMap:
        return asep.make_map(conv_sets=self.conv_sets,
                             num_cache_chips=self.num_cache_chips,
                             sets_per_chip=self.ext_sets_per_chip)


class PoolStats(NamedTuple):
    conv_hits: int
    conv_misses: int
    ext_hits: int
    ext_false_pos: int
    ext_pred_miss: int
    backing_fetches: int
    time_ns: float
    energy_nJ: float

    @staticmethod
    def zero() -> "PoolStats":
        return PoolStats(0, 0, 0, 0, 0, 0, 0.0, 0.0)

    def __add__(self, o: "PoolStats") -> "PoolStats":
        return PoolStats(*[a + b for a, b in zip(self, o)])

    def __sub__(self, o: "PoolStats") -> "PoolStats":
        """Interval delta (epoch telemetry = stats_now - stats_then)."""
        return PoolStats(*[a - b for a, b in zip(self, o)])

    @property
    def lookups(self) -> int:
        return (self.conv_hits + self.conv_misses + self.ext_hits
                + self.ext_false_pos + self.ext_pred_miss)


class GatherPlan(NamedTuple):
    """Where each requested page lives (numpy int32 columns)."""
    tier: np.ndarray        # (N,) 0=conv 1=ext 2=backing(fetch+fill)
    set_idx: np.ndarray     # (N,) set within the tier
    way: np.ndarray         # (N,) way within the set (valid for hits)


# State arrays and their reference dtypes (``pool_to_numpy``); the rest
# are int32 (``ext_level``, ``n_mru``).
_U32_STATE = ("conv_tags", "conv_lru", "ext_tags", "ext_lru", "bf1", "bf2",
              "conv_data", "ext_data", "ext_base")
_BOOL_STATE = ("conv_valid", "ext_valid")
_HOST_STATE = ("ext_size", "ext_used")
STATE_FIELDS = ("conv_tags", "conv_valid", "conv_lru", "ext_tags",
                "ext_valid", "ext_lru", "ext_size", "ext_used", "bf1", "bf2",
                "n_mru", "conv_data", "ext_data", "ext_level", "ext_base")


def _host(t: torch.Tensor) -> np.ndarray:
    """The tensor as a host numpy array (int32 bit patterns stay int32;
    for a CPU tensor a view: read it, do not keep it): a
    ``pool.readback`` span."""
    with obs.span("pool.readback", bytes=t.numel() * t.element_size()):
        return t.cpu().numpy()


def _host_u32(t: torch.Tensor) -> np.ndarray:
    """``_host`` of an int32 bit-pattern tensor, viewed as uint32."""
    return _host(t).view(np.uint32)


def _i32(v: int) -> int:
    """A uint32 value as the int32 of the same bit pattern."""
    v = int(v) & _u32.MASK
    return v - (1 << 32) if v & 0x80000000 else v


class MorpheusPagePool:
    """Functional-core, convenient-shell page pool.

    State tensors live on ``device`` (None: the CUDA card, which must
    exist; ``"cpu"``: the kernels' plain versions); the planning logic is
    numpy (it is per-step control flow, the part real systems keep on the
    host)."""

    def __init__(self, cfg: PoolConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        amap = cfg.amap
        cs, es, w = max(amap.conv_sets, 1), max(amap.ext_sets, 1), cfg.ways

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.conv_tags = zeros(cs, w)
        self.conv_valid = zeros(cs, w, dtype=torch.bool)
        self.conv_lru = zeros(cs, w)
        mw = w * 4 if cfg.compression else w
        self.ext_tags = zeros(es, mw)
        self.ext_valid = zeros(es, mw, dtype=torch.bool)
        self.ext_lru = zeros(es, mw)
        self.ext_size = np.zeros((es, mw), np.int32)
        self.ext_used = np.zeros((es,), np.int32)
        self.bf1 = zeros(es, cfg.bloom_words)
        self.bf2 = zeros(es, cfg.bloom_words)
        self.n_mru = zeros(es)
        # payload pools (uint32 words); extended pool stores BDI payloads
        self.conv_data = zeros(cs, w, cfg.page_words)
        self.ext_data = zeros(es, mw, cfg.page_words)
        self.ext_level = torch.full((es, mw), UNCOMP, dtype=torch.int32,
                                    device=self.device)
        self.ext_base = zeros(es, mw)
        self.stats = PoolStats.zero()
        self.costs = TPUv5e()
        # optional block-level event recorder (pure logging; survives
        # reconfigure like the cumulative stats)
        self.recorder: Optional[TraceRecorder] = None

    def attach_recorder(self, rec: Optional[TraceRecorder] = None
                        ) -> TraceRecorder:
        """Attach (or create) a block-level event recorder."""
        self.recorder = rec if rec is not None else TraceRecorder()
        return self.recorder

    # ------------------------------------------------------------ planning
    def _route(self, keys: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tier int32, local set int32, tag uint32) of uint32 keys."""
        amap = self.cfg.amap
        k = torch.from_numpy(keys.astype(np.int64))
        tier, local = asep.route(amap, k)
        tags = asep.tag_of(amap, k)
        return (tier.numpy().astype(np.int32),
                local.numpy().astype(np.int32),
                tags.numpy().astype(np.uint32))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the pool's device (uint32 as its
        int32 bit pattern)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device, copy=True)

    def lookup_batch(self, keys: np.ndarray) -> GatherPlan:
        """Route a batch of page keys; update predictor/tag state; account
        latency with the reference's serving-tier cost model."""
        with obs.span("pool.lookup", keys=len(keys)) as sp:
            return self._lookup(np.asarray(keys, np.uint32), sp)

    def _lookup(self, keys: np.ndarray, sp) -> GatherPlan:
        cfg = self.cfg
        amap = cfg.amap
        tier, local, tags = self._route(keys)
        conv_mask = tier == asep.CONVENTIONAL
        ext_mask = tier == asep.EXTENDED
        conv_any, ext_any = bool(conv_mask.any()), bool(ext_mask.any())
        sp.set(tier=-1 if conv_any and ext_any else int(ext_any))

        n = len(keys)
        out_tier = np.full(n, 2, np.int32)
        out_set = local.copy()
        out_way = np.zeros(n, np.int32)
        add = dict(conv_hits=0, conv_misses=0, ext_hits=0, ext_false_pos=0,
                   ext_pred_miss=0, backing_fetches=0, time_ns=0.0,
                   energy_nJ=0.0)
        c = self.costs

        # ---- conventional tier: the batch's rounds and fills in one
        # lookup_fill over the full store, its records read back once
        if conv_any:
            idx = np.nonzero(conv_mask)[0]
            rnd, hit, way, evicted, victim = _host(K.lookup_fill(
                self.conv_tags, self.conv_valid, self.conv_lru, local[idx],
                tags[idx]))
            for j in _round_order(rnd):
                gi = idx[j]
                if hit[j]:
                    out_tier[gi] = 0
                    out_way[gi] = way[j]
                    add["conv_hits"] += 1
                    add["time_ns"] += c.local_hbm.hit_latency_ns
                else:
                    if self.recorder is not None:
                        s = int(local[gi])
                        if evicted[j]:
                            self.recorder.record(EV_EVICT, self._key_of(
                                s, int(victim[j]) & _u32.MASK), 0)
                        self.recorder.record(EV_INSERT,
                                             self._key_of(s, tags[gi]), 0)
                    add["conv_misses"] += 1
                    add["backing_fetches"] += 1
                    add["time_ns"] += c.local_hbm.miss_latency_ns

        # ---- extended tier: predictor -> remote lookup
        if ext_any and amap.ext_sets > 0:
            idx = np.nonzero(ext_mask)[0]
            sets = local[idx]
            # predictor: one query of the batch's bf1 rows, read in place
            qt = self._to_dev(np.stack([tags[idx].view(np.int32), sets]))
            pred, _ = K.bloom_query(self.bf1, qt[0], qt[1])
            if cfg.predictor == "none":
                pred = np.ones(len(idx), bool)
            else:
                pred = _host(pred).astype(bool)
            ehit, eway = self._ext_lookup(sets, tags[idx])
            if cfg.predictor == "perfect":
                pred = ehit.copy()
            for j, gi in enumerate(idx):
                if pred[j] and ehit[j]:
                    out_tier[gi] = 1
                    out_way[gi] = eway[j]
                    add["ext_hits"] += 1
                    add["time_ns"] += c.remote_hbm.hit_latency_ns
                elif pred[j]:   # forwarded but miss: full remote penalty
                    add["ext_false_pos"] += 1
                    add["backing_fetches"] += 1
                    add["time_ns"] += c.remote_hbm.miss_latency_ns
                else:           # predicted miss: straight to backing tier
                    add["ext_pred_miss"] += 1
                    add["backing_fetches"] += 1
                    add["time_ns"] += c.local_hbm.miss_latency_ns
            # The reference records each key inside the loop above; one
            # record of the batch after it is the same: the predictor read
            # bf1 before the loop, the stats do not read the filters, and
            # _ext_fill touches no Bloom state.  bloom_record keeps each
            # set's keys in batch order.
            K.bloom_record(self.bf1, self.bf2, self.n_mru, sets, tags[idx],
                           cfg.ways)
            self._ext_fill(sets[~ehit], tags[idx[~ehit]])

        self.stats = self.stats + PoolStats(**add)
        if self.recorder is not None:
            self.recorder.record(EV_LOOKUP, keys, out_tier)
        return GatherPlan(out_tier, out_set, out_way)

    # ------------------------------------------------------------ payloads
    def _words(self, payload):
        """A page payload as one (1, page_words) page: a host uint32 array
        (from a numpy array of uint32 values), or an int32 bit-pattern
        tensor moved to the device."""
        if isinstance(payload, torch.Tensor):
            if payload.dtype != torch.int32:
                raise TypeError(f"payload tensor dtype {payload.dtype}, "
                                f"expected torch.int32 (bit patterns)")
            words = payload.to(self.device)
        else:
            words = np.asarray(payload, np.uint32)
        if tuple(words.shape) != (self.cfg.page_words,):
            raise ValueError(f"payload shape {tuple(words.shape)}, expected "
                             f"({self.cfg.page_words},)")
        return words.reshape(1, -1)

    def write_page(self, key: int, payload_words) -> None:
        """Install a page payload after a backing fetch (insert path): one
        ``page_write`` (the probe of the key's set, BDI compression on the
        extended tier, the store write) after one copy of the key and a
        host payload to the device, and no read-back."""
        cfg = self.cfg
        with obs.span("pool.write", keys=1) as sp:
            tier, local, tag = self._route(np.asarray([key], np.uint32))
            sp.set(tier=int(tier[0]))
            page = self._words(payload_words)
            if tier[0] == asep.CONVENTIONAL:
                K.page_write(self.conv_tags, self.conv_valid, self.conv_data,
                             None, None, local, tag, page)
                return
            comp = cfg.compression
            K.page_write(self.ext_tags, self.ext_valid, self.ext_data,
                         self.ext_level if comp else None,
                         self.ext_base if comp else None, local, tag, page)

    def read_pages(self, plan: GatherPlan) -> torch.Tensor:
        """Gather hit pages per plan, as (N, page_words) int32 bit
        patterns on the device (tier 2 rows are zeros: the caller fetches
        those from the backing store): one copy of the plan to the device
        and one ``read_rows`` (the fused Indirect-MOV gather + BDI
        decompress-on-read) over both tiers' stores."""
        cols = self._to_dev(np.stack([plan.tier, plan.set_idx, plan.way]
                                     ).astype(np.int32))
        return K.read_rows(self.conv_data, self.ext_data, self.ext_level,
                           self.ext_base, cols[0], cols[1], cols[2])

    # ------------------------------------------------------------ internals
    def _key_of(self, gset: int, tag: int) -> int:
        """Inverse of route/tag_of: the page key resident at (global set,
        tag): key = tag * total_sets + gset."""
        return (int(tag) * self.cfg.amap.total_sets + int(gset)) \
            & 0xFFFFFFFF

    def _victim(self, valid, lru, s: int) -> Tuple[int, bool]:
        """(way, was valid) of set ``s``'s LRU victim: the least counter,
        invalid ways (as -1) first, the lowest way on ties."""
        row_v = _host(valid[s])
        row_l = _host_u32(lru[s]).astype(np.int64)
        row_l[~row_v] = -1
        w = int(np.argmin(row_l))
        return w, bool(row_v[w])

    def _ext_lookup(self, sets: np.ndarray, tags: np.ndarray):
        t = _host_u32(self.ext_tags)[sets]
        v = _host(self.ext_valid)[sets]
        m = v & (t == tags[:, None])
        return m.any(axis=1), np.argmax(m, axis=1).astype(np.int32)

    def _ext_fill(self, sets: np.ndarray, tags: np.ndarray):
        conv_sets = self.cfg.amap.conv_sets
        for s, tag in zip(sets, tags):
            s = int(s)
            w, was_valid = self._victim(self.ext_valid, self.ext_lru, s)
            if self.recorder is not None:
                gs = conv_sets + s
                if was_valid:
                    old = int(self.ext_tags[s, w]) & _u32.MASK
                    self.recorder.record(EV_EVICT, self._key_of(gs, old), 1)
                self.recorder.record(EV_INSERT, self._key_of(gs, tag), 1)
            self.ext_tags[s, w] = _i32(tag)
            self.ext_valid[s, w] = True
            self.ext_lru[s, w] = 0xFFF

    # ------------------------------------------------------------- metrics
    def hit_rate(self) -> float:
        s = self.stats
        total = (s.conv_hits + s.conv_misses + s.ext_hits + s.ext_false_pos
                 + s.ext_pred_miss)
        return (s.conv_hits + s.ext_hits) / max(total, 1)

    def occupancy(self) -> Tuple[float, float]:
        """(conventional, extended) fraction of valid page slots."""
        conv = float(_host(self.conv_valid).mean())
        ext = (float(_host(self.ext_valid).mean())
               if self.cfg.num_cache_chips else 0.0)
        return conv, ext

    def telemetry(self) -> Dict[str, float]:
        """Observable request-mix snapshot for a serving governor."""
        s = self.stats
        conv_occ, ext_occ = self.occupancy()
        ext_total = s.ext_hits + s.ext_false_pos + s.ext_pred_miss
        return {
            "lookups": float(s.lookups),
            "hit_rate": self.hit_rate(),
            "conv_occupancy": conv_occ,
            "ext_occupancy": ext_occ,
            "pred_accuracy": (s.ext_hits + s.ext_pred_miss)
            / max(ext_total, 1),
            "time_ns_per_lookup": s.time_ns / max(s.lookups, 1),
            "num_cache_chips": float(self.cfg.num_cache_chips),
        }

    # -------------------------------------------------------- introspection
    def resident_keys(self) -> Tuple[np.ndarray, np.ndarray]:
        """(conventional, extended) page keys currently resident: a
        read-only decode of the tag stores (key = tag * total + set)."""
        amap = self.cfg.amap
        total = max(amap.total_sets, 1)
        cv = _host(self.conv_valid)
        s_idx, w_idx = np.nonzero(cv)
        conv = (_host_u32(self.conv_tags)[s_idx, w_idx].astype(np.uint64)
                * total + s_idx.astype(np.uint64)).astype(np.uint32)
        ev = _host(self.ext_valid)
        e_s, e_w = np.nonzero(ev)
        ext = (_host_u32(self.ext_tags)[e_s, e_w].astype(np.uint64)
               * total + (amap.conv_sets + e_s).astype(np.uint64)
               ).astype(np.uint32)
        if amap.ext_sets == 0:
            ext = ext[:0]
        return conv, ext

    def content_snapshot(self, *, epoch: int = 0, replica: str = "serving",
                         owners: Optional[Dict[int, str]] = None):
        """Decoded cache-content ``obs.inspect.Snapshot`` of the pool.

        ``owners`` maps page key -> tenant label (the serving engine's
        consult-time notes, ``obs.Inspector.owners``); keys without a
        note count under ``"?"``."""
        from ..obs.inspect import Snapshot, bloom_fill_ratio
        cv = _host(self.conv_valid)
        ev = _host(self.ext_valid)
        conv_occ = cv.sum(axis=1).astype(np.int64)
        ext_occ = ev.sum(axis=1).astype(np.int64)
        s = self.stats
        fp, pm = s.ext_false_pos, s.ext_pred_miss
        residency: Dict[str, int] = {}
        if owners is not None:
            conv_k, ext_k = self.resident_keys()
            for k in np.concatenate([conv_k, ext_k]):
                label = owners.get(int(k), "?")
                residency[label] = residency.get(label, 0) + 1
        chips = self.cfg.num_cache_chips
        return Snapshot(
            epoch=int(epoch), pos=int(s.lookups), replica=replica,
            conv_set_occ=[int(x) for x in conv_occ],
            ext_set_occ=[int(x) for x in ext_occ],
            conv_occupancy=float(cv.mean()),
            ext_occupancy=float(ev.mean()) if chips else 0.0,
            byte_util=float(ev.mean()) if chips else 0.0,
            bloom_fill=bloom_fill_ratio(_host_u32(self.bf1))
            if chips else 0.0,
            bloom_fp_rate=fp / max(fp + pm, 1),
            residency=residency)

    # ------------------------------------------------------ mode transition
    def reconfigure(self, num_cache_chips: int) -> int:
        """Mode transition: re-provision the pool for a new cache-chip
        count.  The static address separation is recomputed, so every
        resident page is flushed (pages are clean, so there is no
        writeback to charge).  Cumulative stats and the recorder survive.
        Returns the number of resident pages dropped."""
        if num_cache_chips == self.cfg.num_cache_chips:
            return 0
        flushed = int(_host(self.conv_valid).sum())
        if self.cfg.num_cache_chips:
            flushed += int(_host(self.ext_valid).sum())
        stats, rec = self.stats, self.recorder
        if rec is not None and flushed:
            # a mode transition flushes every resident page: those are
            # evict events like any other
            conv_k, ext_k = self.resident_keys()
            if len(conv_k):
                rec.record(EV_EVICT, conv_k, 0)
            if len(ext_k):
                rec.record(EV_EVICT, ext_k, 1)
        self.__init__(replace_cfg(self.cfg, num_cache_chips), self.device)
        self.stats = stats
        self.recorder = rec
        return flushed


def replace_cfg(cfg: PoolConfig, num_cache_chips: int) -> PoolConfig:
    """A PoolConfig with a different cache-chip count (frozen dataclass)."""
    return replace(cfg, num_cache_chips=num_cache_chips)


def _round_order(rnd: np.ndarray) -> np.ndarray:
    """The requests that ran (round ``rnd >= 0``) in the reference's
    accounting order: round by round, and within a round in batch order
    (its ``_first_per_set``); those past the rounds (-1) get tier 2 and
    are counted nowhere."""
    ran = np.flatnonzero(rnd >= 0)
    return ran[np.lexsort((ran, rnd[ran]))]


def page_key(seq_hash: int, layer: int, page: int) -> int:
    """Stable 32-bit page key from (sequence-prefix hash, layer, page#).
    Python-int arithmetic masked to 64 bits (wraparound is intentional)."""
    m64 = (1 << 64) - 1
    x = (int(seq_hash) * 0x9E3779B97F4A7C15
         + int(layer) * 0x85EBCA77C2B2AE63
         + int(page)) & m64
    x ^= x >> 33
    return x & 0xFFFFFFFF


# ------------------------------------------------------ state carried across

def pool_to_numpy(pool: MorpheusPagePool) -> Dict[str, object]:
    """The pool's state as numpy arrays in the reference's dtypes (uint32
    tags, LRU, Bloom words, payloads and bases; bool valid bits; int32
    levels, MRU counts and host counters), plus ``"stats"``."""
    out: Dict[str, object] = {}
    for name in STATE_FIELDS:
        x = getattr(pool, name)
        if name in _HOST_STATE:
            out[name] = x.copy()
        elif name in _U32_STATE:
            out[name] = _host_u32(x).copy()
        else:
            out[name] = _host(x).copy()
    out["stats"] = pool.stats
    return out


def pool_from_numpy(cfg: PoolConfig, arrays: Dict[str, object],
                    device=None) -> MorpheusPagePool:
    """A pool on ``device`` holding the state ``arrays``: numpy arrays in
    the reference's dtypes under ``STATE_FIELDS``' names (as
    ``pool_to_numpy`` gives them, or as ``np.asarray`` reads a reference
    pool's fields), and ``"stats"``."""
    pool = MorpheusPagePool(cfg, device)
    for name in STATE_FIELDS:
        cur = getattr(pool, name)
        a = np.asarray(arrays[name])
        if a.shape != tuple(cur.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(cur.shape)}")
        if name in _HOST_STATE:
            setattr(pool, name, a.astype(np.int32))
        elif name in _U32_STATE:
            setattr(pool, name, pool._to_dev(a.astype(np.uint32)))
        elif name in _BOOL_STATE:
            setattr(pool, name, pool._to_dev(a.astype(bool)))
        else:
            setattr(pool, name, pool._to_dev(a.astype(np.int32)))
    pool.stats = PoolStats(*arrays["stats"])
    return pool
