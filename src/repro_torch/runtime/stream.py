"""Epoch-streaming resumable engine path, after ``repro.runtime.stream``.

``EpochStream`` replays one trace through the set-parallel engine in
fixed-length epochs, carrying the full simulator state between epochs as
an explicit ``core.engine.EngineState`` (tensors on the stream's
device).  Each epoch is one ``engine.advance_packed`` dispatch: on the
card the two stateful scans (``kernels/engine_scan.py`` ``conv_scan`` and
``ext_scan`` with state rows in and out), on the CPU their plain
versions.  Because the packed scan applies the same transition in the
same in-set order wherever the trace is cut, the accumulated integer
Stats equal one monolithic run.

The second half is the mode-transition machinery the governor needs:
``handoff`` migrates an ``EngineState`` from one mode split's config to
another.  Resident blocks are extracted (their addresses are
recoverable from tag + set), re-routed under the new address map and
re-inserted most-recent-first until ways and byte budgets fill;
everything else is flushed, dirty blocks charged as writebacks (the
paper's §4.1.3 transition cost).  The rows are rebuilt on the host in
the reference's numpy dtypes (lru = ``LRU_MAX_INT - k``, sizes carried
over, one way a tag), which is the row contract the CUDA scans check
before every launch.  The extended tier's BF1 filters are rebuilt from
the surviving tags.

Where the reference maps ``jax.tree`` over ``Stats`` and ``EngineState``,
the port walks the NamedTuples' fields.  State files (``save_state`` /
``load_state``) hold the leaves in the reference's pytree order and
dtypes (uint32 tags, LRU counters and Bloom words), so a file written by
either package loads in the other.

The device ring (``ring=N``) packs up to N upcoming epochs ahead and
copies them to the card from pinned host memory on a side stream; an
event recorded after the copies orders them before the scans that read
them (the compute stream waits on it), so a scan never reads a
half-copied epoch.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import bloom as bloomlib
from ..core import controller as ctl
from ..core import engine
from ..core.compression import BLOCK_BYTES
from ..core.controller import MorpheusConfig, Stats
from ..core.engine import EngineState, PackedTraces
from ..core.tag_store import LRU_MAX_INT


class StreamSnapshot(NamedTuple):
    """A resumable ``EpochStream`` checkpoint: the engine carry (numpy
    leaves in the reference's dtypes) plus the stream-level bookkeeping
    that is NOT recoverable from the carry — the stream position (the
    carry's ``pos`` is cumulative across warm handoffs), the epoch
    counter, and the Bloom probe-counter baselines the stream measures
    its cumulative false-positive rate against."""
    state: EngineState
    pos: int
    epoch: int
    probe_base: Tuple[int, int]     # (ext_false_pos, ext_pred_miss)
    # serving-layer carry (``attach_serving``): one JSON-clean state dict
    # per attached component; None for plain simulator streams
    serving: Optional[Tuple[dict, ...]] = None


def _first_row(stats: Stats) -> Stats:
    return Stats(*[x[0] for x in stats])


def _row_sum(stats: Stats) -> Stats:
    return Stats(*[x.sum(dim=0) for x in stats])


def _host_state(state: EngineState) -> EngineState:
    """``state`` with numpy leaves in the reference's dtypes (a state
    that already has numpy leaves is returned as it is)."""
    if isinstance(state.pos, torch.Tensor):
        return engine.state_to_numpy(state)
    return state


def _device_state(cfg: MorpheusConfig, state: EngineState,
                  device: torch.device) -> EngineState:
    """``state`` as tensors on ``device``: numpy leaves (the reference's
    dtypes) are converted, tensors copied."""
    if isinstance(state.pos, torch.Tensor):
        return EngineState(
            *[x.to(device, copy=True) for x in state[:-2]],
            stats=Stats(*[x.to(device, copy=True) for x in state.stats]),
            pos=state.pos.to(device, copy=True))
    return engine.state_from_numpy(cfg, state, device)


class EpochStream:
    """Resumable epoch-by-epoch replay of one trace under one config.

    The trace can be raw arrays (``EpochStream(cfg, addrs, writes,
    levels)``) or a composed multi-tenant ``workloads.Workload``
    (``EpochStream(cfg, workload)``), which brings its own epoching
    (``epoch_len``, ``window_s`` or ``target_epoch``) and K tenants: the
    state then carries K rows replaying the same requests under
    per-tenant count masks, so ``stats`` sums the rows and
    ``tenant_stats()`` gives the per-tenant split.

    ``device=None`` runs on the CUDA card (``BackendError`` without one);
    ``device="cpu"`` runs the plain versions.  ``ring`` keeps up to that
    many upcoming epochs packed and parked on the device (see the module
    docstring); the stream position is mirrored on the host, so stepping
    never reads the device to learn it.
    """

    def __init__(self, cfg: MorpheusConfig, addrs, writes=None, levels=None,
                 *, warmup: int = 0, epoch_len: Optional[int] = 4096,
                 window_s: Optional[float] = None,
                 target_epoch: Optional[int] = None,
                 device=None, ring: int = 0,
                 state: Optional[EngineState] = None):
        self.cfg = cfg
        self.workload = None
        if writes is None and levels is None and hasattr(addrs, "tenants"):
            wl = addrs
            self.workload = wl
            self.addrs = wl.addrs
            self.writes = wl.writes
            self.levels = wl.levels
            if window_s is not None or target_epoch is not None:
                epoch_len = None
            self._bounds: Optional[List[Tuple[int, int]]] = wl.epoch_bounds(
                epoch_len=epoch_len, window_s=window_s,
                target_epoch=target_epoch)
            self._masks = wl.tenant_masks()
            self._churn = wl.has_churn()
        else:
            assert writes is not None and levels is not None
            assert window_s is None and target_epoch is None, \
                "raw traces have no timestamps; wall-clock epoching " \
                "needs a workloads.Workload"
            assert epoch_len and epoch_len > 0
            self.addrs = np.asarray(addrs, np.uint32)
            self.writes = np.asarray(writes, bool)
            self.levels = np.asarray(levels, np.int32)
            self._bounds = None
            self._masks = [None]
            self._churn = False
        self._sig: Optional[int] = None
        self.churn_events: List[Tuple[int, int, int]] = []
        self.warmup = int(warmup)
        self.epoch_len = int(epoch_len) if epoch_len else 0
        self.device = engine.resolve_device(device)
        k = len(self._masks)
        self.state = _device_state(cfg, state, self.device) \
            if state is not None else engine.init_state(cfg, k, self.device)
        assert int(self.state.pos.shape[0]) == k, \
            f"state batch {self.state.pos.shape[0]} != tenant count {k}"
        # ``state.pos`` counts every request the state ever consumed
        # (possibly across earlier traces, after a warm handoff); the
        # stream's position in *this* trace is mirrored on the host
        self._base = int(self.state.pos[0])
        self._host_pos = 0
        self.epoch = 0
        self._probe_base = self._probe_totals()
        self.ring = int(ring)
        self._ring: Deque[Tuple[int, int, PackedTraces, object]] = deque()
        self._packed_to = 0
        self._copy_stream = None
        self._serving: List = []

    def attach_serving(self, *components) -> None:
        """Register serving-layer components (anything with
        ``export_state()`` / ``restore_state(d)``) whose state rides
        along in ``snapshot()``/``restore()`` and the state files, in
        attachment order."""
        for c in components:
            assert callable(getattr(c, "export_state", None)) and \
                callable(getattr(c, "restore_state", None)), \
                f"{type(c).__name__} lacks export_state/restore_state"
            self._serving.append(c)

    # ------------------------------------------------------------- basics
    @property
    def pos(self) -> int:
        return self._host_pos

    @property
    def done(self) -> bool:
        return self.pos >= len(self.addrs)

    @property
    def stats(self) -> Stats:
        """Accumulated global Stats so far (0-d tensor leaves; with K
        tenants the sum of the per-tenant rows)."""
        if len(self._masks) == 1:
            return _first_row(self.state.stats)
        return _row_sum(self.state.stats)

    def _probe_totals(self) -> Tuple[int, int]:
        st = self.state.stats
        return (int(st.ext_false_pos.sum()), int(st.ext_pred_miss.sum()))

    def probe_counters(self) -> Tuple[int, int]:
        """Cumulative Bloom probe counters of this stream (state totals
        minus the warm-start baseline): (false positives, predicted
        misses)."""
        fp, pm = self._probe_totals()
        return fp - self._probe_base[0], pm - self._probe_base[1]

    def fp_rate(self) -> float:
        """Measured cumulative false-positive rate of the Bloom
        predictor over this stream's probes."""
        fp, pm = self.probe_counters()
        return fp / max(fp + pm, 1)

    def tenant_stats(self) -> Dict[str, Stats]:
        """Per-tenant accumulated Stats (workload mode only; numpy
        leaves)."""
        assert self.workload is not None, "raw-trace stream has no tenants"
        host = [x.cpu().numpy() for x in self.state.stats]
        return {t.name: Stats(*[x[k] for x in host])
                for k, t in enumerate(self.workload.tenants)}

    # ----------------------------------------------------------- epoching
    def _next_bound(self, lo: int) -> int:
        if self._bounds is None:
            return min(lo + self.epoch_len, len(self.addrs))
        for b_lo, b_hi in self._bounds:
            if b_lo <= lo < b_hi:
                return b_hi
        return len(self.addrs)

    def _pack_epoch(self, lo: int, hi: int) -> PackedTraces:
        with obs.span("stream.pack", lo=lo, hi=hi):
            return self._pack_epoch_inner(lo, hi)

    def _pack_epoch_inner(self, lo: int, hi: int) -> PackedTraces:
        k = len(self._masks)
        sl = slice(lo, hi)
        traces = [(self.addrs[sl], self.writes[sl], self.levels[sl],
                   self.warmup)] * k
        count = None
        if self.workload is not None and k > 1:
            count = [m[sl] for m in self._masks]
            if self._churn:
                # a departed or not-yet-arrived tenant's mask slice must be
                # all-False: validate the activity-interval invariant
                act = self.workload.active_mask(lo, hi)
                for j, m in enumerate(count):
                    assert act[j] or not m.any(), \
                        (f"tenant {j} marked inactive over [{lo},{hi}) "
                         f"but has {int(m.sum())} requests there")
        return engine.pack(self.cfg, traces, pos0=[lo] * k, count=count)

    # --------------------------------------------------------------- ring
    def _park(self, pt: PackedTraces) -> Tuple[PackedTraces, object]:
        """An epoch's packed arrays as tensors on the device, and the
        event that marks their copy done (None on the CPU).  On the card
        the arrays are pinned and copied on a side stream."""
        if self.device.type != "cuda":
            return engine.to_device(pt, self.device), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host = [torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a)).pin_memory()
            for a in pt]
        with torch.cuda.stream(self._copy_stream):
            parked = [h.to(self.device, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return PackedTraces(*parked), done

    def _fill_ring(self) -> None:
        """Pre-pack upcoming epochs and park them on the device."""
        if self._packed_to < self._host_pos:
            self._packed_to = self._host_pos
        while len(self._ring) < self.ring and \
                self._packed_to < len(self.addrs):
            lo = self._packed_to
            hi = self._next_bound(lo)
            with obs.span("stream.ring_fill", lo=lo, hi=hi,
                          depth=len(self._ring)):
                pt, done = self._park(self._pack_epoch(lo, hi))
            self._ring.append((lo, hi, pt, done))
            self._packed_to = hi

    def step(self) -> Stats:
        """Advance one epoch; returns this epoch's global Stats delta."""
        with obs.span("stream.step", epoch=self.epoch,
                      ring=self.ring) as sp:
            lo = self._host_pos
            assert lo < len(self.addrs), "stream exhausted"
            if self.ring:
                self._fill_ring()
                lo, hi, pt, done = self._ring.popleft()
                if done is not None:
                    # the scans run on the compute stream: it waits for
                    # this epoch's copies, and the allocator learns that
                    # the compute stream uses the side stream's tensors
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(done)
                    for t in pt:
                        t.record_stream(cur)
            else:
                hi = self._next_bound(lo)
                pt = self._pack_epoch(lo, hi)
            sp.set(lo=lo, hi=hi)
            if self.workload is not None:
                sig = self.workload.active_signature(lo, hi)
                if self._sig is not None and sig != self._sig:
                    self.churn_events.append((self.epoch, self._sig, sig))
                self._sig = sig
            self.state, delta = engine.advance_packed(self.cfg, pt,
                                                      self.state,
                                                      self.device)
            obs.count("epochs", 1, path="stream")
            ins = obs.inspector()
            if ins is not None and ins.wants(self.epoch):
                self._record_snapshot(ins)
            self.epoch += 1
            self._host_pos = hi
            if len(self._masks) == 1:
                return _first_row(delta)
            return _row_sum(delta)

    def _record_snapshot(self, ins) -> None:
        """Cache-microscope hook: decode the post-epoch carry into a
        content snapshot (host-side, off the dispatch path)."""
        from ..obs import inspect as obs_inspect
        dec = engine.decode_state(self.cfg, self.state)
        stride, names = 0, None
        if self.workload is not None:
            from ..workloads.tenancy import TENANT_STRIDE_BLOCKS
            stride = TENANT_STRIDE_BLOCKS
            names = [t.name for t in self.workload.tenants]
        ins.record(obs_inspect.snapshot_from_decode(
            dec, epoch=self.epoch, conv_ways=self.cfg.conv_ways,
            ext_max_ways=self.cfg.ext_max_ways,
            ext_budget_bytes=self.cfg.ext_budget_bytes,
            block_bytes=BLOCK_BYTES, tenant_stride=stride,
            tenant_names=names, probe_counters=self.probe_counters()))
        obs.count("state_snapshots", 1, path="stream")

    def run(self) -> Stats:
        """Drain the remaining epochs; returns the accumulated Stats."""
        while not self.done:
            self.step()
        return self.stats

    # --------------------------------------------------- snapshot/restore
    def snapshot(self) -> StreamSnapshot:
        """Host-materialized checkpoint: the full carry (numpy leaves in
        the reference's dtypes) plus the stream position, epoch counter
        and probe baselines."""
        return StreamSnapshot(state=engine.state_to_numpy(self.state),
                              pos=self._host_pos, epoch=self.epoch,
                              probe_base=self._probe_base,
                              serving=tuple(c.export_state()
                                            for c in self._serving)
                              if self._serving else None)

    def restore(self, state: StreamSnapshot | EngineState) -> None:
        """Resume from a ``StreamSnapshot`` (position, epoch counter and
        probe baselines carry over) or a bare ``EngineState`` (position
        re-derived from the carry's cumulative ``pos``); the state's
        leaves may be numpy arrays (the reference's dtypes) or tensors."""
        if isinstance(state, StreamSnapshot):
            self.epoch = int(state.epoch)
            self._probe_base = (int(state.probe_base[0]),
                                int(state.probe_base[1]))
            self._host_pos = int(state.pos)
            serving = getattr(state, "serving", None)
            if serving is not None:
                assert len(serving) == len(self._serving), \
                    (f"snapshot carries {len(serving)} serving states "
                     f"but {len(self._serving)} components are attached")
                for c, d in zip(self._serving, serving):
                    c.restore_state(d)
            state = state.state
            self.state = _device_state(self.cfg, state, self.device)
            self._base = int(self.state.pos[0]) - self._host_pos
        else:
            self.state = _device_state(self.cfg, state, self.device)
            self._host_pos = int(self.state.pos[0]) - self._base
        # pre-packed epochs and the churn detector's last signature belong
        # to wherever the stream was before the rollback
        self._ring.clear()
        self._packed_to = self._host_pos
        self._sig = None


_STREAM_META_KEY = "stream_meta"
_SERVING_META_KEY = "serving_meta"
_N_LEAVES = len(EngineState._fields) - 1 + len(Stats._fields)


def _leaves(state: EngineState) -> List[np.ndarray]:
    """The state's leaves in the reference's pytree order: the 13 row
    fields, the ``Stats`` fields, then ``pos``."""
    st = _host_state(state)
    return ([np.asarray(x) for x in st[:-2]]
            + [np.asarray(x) for x in st.stats] + [np.asarray(st.pos)])


def save_state(path: str | Path,
               state: StreamSnapshot | EngineState) -> Path:
    """Serialize an ``EngineState`` or ``StreamSnapshot`` to ``.npz``:
    the leaves in the reference's pytree order and dtypes (uint32 tags,
    LRU counters and Bloom words), the snapshot metadata and serving
    state under reserved side keys, as the reference writes them."""
    path = Path(path)
    meta = serving = None
    if isinstance(state, StreamSnapshot):
        meta = np.asarray([state.pos, state.epoch,
                           state.probe_base[0], state.probe_base[1]],
                          np.int64)
        if state.serving is not None:
            serving = np.frombuffer(
                json.dumps(list(state.serving)).encode(), np.uint8)
        state = state.state
    arrs = {f"leaf{i}": x for i, x in enumerate(_leaves(state))}
    if meta is not None:
        arrs[_STREAM_META_KEY] = meta
    if serving is not None:
        arrs[_SERVING_META_KEY] = serving
    np.savez(path, **arrs)
    return path


def load_state(path: str | Path, cfg: MorpheusConfig,
               batch: int = 1) -> StreamSnapshot | EngineState:
    """Load a state saved by ``save_state`` (of either package): numpy
    leaves in the reference's dtypes, checked against the shapes of
    ``engine.init_state(cfg, batch)``.  Files written from a
    ``StreamSnapshot`` load back as one; bare states as an
    ``EngineState``."""
    with np.load(Path(path)) as z:
        meta = z[_STREAM_META_KEY] if _STREAM_META_KEY in z.files else None
        serving = None
        if _SERVING_META_KEY in z.files:
            serving = tuple(json.loads(z[_SERVING_META_KEY].tobytes()))
        n = len(z.files) - (1 if meta is not None else 0) \
            - (1 if serving is not None else 0)
        leaves = [z[f"leaf{i}"] for i in range(n)]
    if n != _N_LEAVES:
        raise ValueError(f"{path}: {n} state leaves, expected {_N_LEAVES}")
    want = _leaves(engine.init_state(cfg, batch, "cpu"))
    for i, (a, w) in enumerate(zip(leaves, want)):
        if a.shape != w.shape:
            raise ValueError(f"{path}: leaf{i} has shape {a.shape}, config "
                             f"and batch need {w.shape}")
    nrow = len(EngineState._fields) - 2
    state = EngineState(*leaves[:nrow],
                        stats=Stats(*leaves[nrow:nrow + len(Stats._fields)]),
                        pos=leaves[-1])
    if meta is None:
        return state
    return StreamSnapshot(state=state, pos=int(meta[0]), epoch=int(meta[1]),
                          probe_base=(int(meta[2]), int(meta[3])),
                          serving=serving)


# ------------------------------------------------------- mode transitions

def flush_energy_nJ_per_block(cfg: MorpheusConfig) -> float:
    """DRAM-writeback energy charged per flushed dirty block.  One
    definition on purpose: ``handoff`` charges it per state row, the
    online driver on the next epoch's delta, and the multi-tenant replay
    un-charges it per tenant row; the per-tenant sums equal the global
    ones only while all three use the same arithmetic."""
    return BLOCK_BYTES * cfg.costs.dram.energy_pJ_per_B * 1e-3


@dataclass(frozen=True)
class HandoffReport:
    """What a mode transition did to the resident working set."""
    resident_before: int
    migrated: int            # blocks surviving into the new state
    dropped: int             # blocks flushed (region moved / no room)
    flush_writebacks: int    # of those, dirty blocks written back
    flushed_bytes: int       # writeback DRAM traffic in bytes
    # full addresses of trace 0's flushed dirty blocks (the multi-tenant
    # replay maps them back to tenants: addr // TENANT_STRIDE_BLOCKS)
    dropped_dirty_addr: np.ndarray = None  # type: ignore[assignment]


def extract_blocks(cfg: MorpheusConfig, state: EngineState,
                   trace: int = 0) -> Dict[str, np.ndarray]:
    """Recover the resident block population of one trace's state
    (tensor or numpy leaves): parallel arrays addr/dirty/recency/size,
    ``addr = tag * total_sets + global_set``, recency the per-set LRU
    counter."""
    st = _host_state(state)
    total = max(cfg.amap.total_sets, 1)
    out_addr, out_dirty, out_rec, out_size = [], [], [], []

    s_idx, w_idx = np.nonzero(st.conv_valid[trace])
    tags = st.conv_tags[trace][s_idx, w_idx].astype(np.uint64)
    out_addr.append(tags * total + s_idx.astype(np.uint64))
    out_dirty.append(st.conv_dirty[trace][s_idx, w_idx])
    out_rec.append(st.conv_lru[trace][s_idx, w_idx].astype(np.int64))
    out_size.append(np.full(len(s_idx), BLOCK_BYTES, np.int32))

    if cfg.ext_enabled:
        s_idx, w_idx = np.nonzero(st.ext_valid[trace])
        tags = st.ext_tags[trace][s_idx, w_idx].astype(np.uint64)
        gset = (cfg.amap.conv_sets + s_idx).astype(np.uint64)
        out_addr.append(tags * total + gset)
        out_dirty.append(st.ext_dirty[trace][s_idx, w_idx])
        out_rec.append(st.ext_lru[trace][s_idx, w_idx].astype(np.int64))
        out_size.append(st.ext_size[trace][s_idx, w_idx])

    return {"addr": np.concatenate(out_addr),
            "dirty": np.concatenate(out_dirty),
            "recency": np.concatenate(out_rec),
            "size": np.concatenate(out_size)}


def _rebuild_bf1(tags: np.ndarray, sets: np.ndarray, n_sets: int,
                 words: int) -> np.ndarray:
    """BF1 filters containing exactly the given (set, tag) residents (no
    false negatives by construction), through the port's
    ``core.bloom._hash_bits``."""
    bf1 = np.zeros((n_sets, words), np.uint32)
    if len(tags) == 0:
        return bf1
    bits = bloomlib._hash_bits(
        torch.from_numpy(np.asarray(tags, np.uint32).astype(np.int64)),
        words * 32).numpy()                                     # (N, k)
    word_idx = bits // 32
    masks = (np.uint32(1) << (bits % 32).astype(np.uint32))
    rows = np.repeat(sets, bits.shape[1])
    np.bitwise_or.at(bf1, (rows, word_idx.ravel()), masks.ravel())
    return bf1


def handoff(old_cfg: MorpheusConfig, state: EngineState,
            new_cfg: MorpheusConfig, *, migrate: bool = True
            ) -> Tuple[EngineState, HandoffReport]:
    """Mode transition: carry an ``EngineState`` across a split change.

    Every resident block is re-routed under ``new_cfg``'s map and
    re-inserted most-recent-first until the target set's ways (and, on
    the extended tier, byte budget) fill; the rest is flushed, dirty
    blocks charged as writebacks, DRAM bytes and DRAM energy on the
    carried Stats.  ``migrate=False`` flushes everything (cold restart).
    Accumulated Stats and the position carry over; the new state lies on
    the old one's device.
    """
    with obs.span("stream.handoff", migrate=migrate,
                  rows=int(state.pos.shape[0])) as sp:
        new, rep = _handoff(old_cfg, state, new_cfg, migrate=migrate)
        sp.set(resident=rep.resident_before, migrated=rep.migrated,
               dropped=rep.dropped, flush_writebacks=rep.flush_writebacks)
        obs.count("flush_writebacks", rep.flush_writebacks)
        return new, rep


def _handoff(old_cfg: MorpheusConfig, state: EngineState,
             new_cfg: MorpheusConfig, *, migrate: bool = True
             ) -> Tuple[EngineState, HandoffReport]:
    dev = state.pos.device if isinstance(state.pos, torch.Tensor) \
        else torch.device("cpu")
    old = _host_state(state)
    b = old.pos.shape[0]
    host = engine.state_to_numpy(engine.init_state(new_cfg, b, "cpu"))
    host = EngineState(*[np.array(x) for x in host[:-2]],
                       stats=host.stats, pos=host.pos)  # writable copies
    amap = new_cfg.amap
    total = max(amap.total_sets, 1)
    words = ctl.BLOOM_WORDS
    resident = migrated = dropped = 0
    wbs_t = np.zeros(b, np.int32)
    drop_dirty0 = np.zeros(0, np.uint64)

    for t in range(b):
        blocks = extract_blocks(old_cfg, old, t)
        n = len(blocks["addr"])
        resident += n
        if n == 0:
            continue
        if not migrate:
            dropped += n
            wbs_t[t] += int(blocks["dirty"].sum())
            if t == 0:
                drop_dirty0 = blocks["addr"][blocks["dirty"]]
            continue
        # most-recent first; tie-break on address for determinism
        order = np.lexsort((blocks["addr"], -blocks["recency"]))
        addr = blocks["addr"][order]
        dirty = blocks["dirty"][order]
        size = blocks["size"][order]
        if not new_cfg.compression:
            size = np.full_like(size, BLOCK_BYTES)
        gset = (addr % total).astype(np.int64)
        tag = (addr // total).astype(np.uint32)
        is_ext = new_cfg.ext_enabled & (gset >= amap.conv_sets)

        kept = np.zeros(n, bool)
        fill: Dict[Tuple[int, int], int] = {}   # (tier, set) -> ways used
        used = np.zeros(max(amap.ext_sets, 1), np.int64)
        budget = new_cfg.ext_budget_bytes
        for i in range(n):
            if is_ext[i]:
                s = int(gset[i] - amap.conv_sets)
                k = fill.get((1, s), 0)
                if k >= new_cfg.ext_max_ways or used[s] + size[i] > budget:
                    continue
                host.ext_tags[t, s, k] = tag[i]
                host.ext_valid[t, s, k] = True
                host.ext_dirty[t, s, k] = dirty[i]
                host.ext_lru[t, s, k] = LRU_MAX_INT - k
                host.ext_size[t, s, k] = size[i]
                used[s] += int(size[i])
                fill[(1, s)] = k + 1
                kept[i] = True
            else:
                s = int(gset[i])
                k = fill.get((0, s), 0)
                if s >= amap.conv_sets or k >= new_cfg.conv_ways:
                    continue
                host.conv_tags[t, s, k] = tag[i]
                host.conv_valid[t, s, k] = True
                host.conv_dirty[t, s, k] = dirty[i]
                host.conv_lru[t, s, k] = LRU_MAX_INT - k
                fill[(0, s)] = k + 1
                kept[i] = True
        if amap.ext_sets:
            host.ext_used[t] = used[:amap.ext_sets].astype(np.int32)
            e = kept & is_ext
            host.bf1[t] = _rebuild_bf1(
                tag[e], (gset[e] - amap.conv_sets).astype(np.int64),
                amap.ext_sets, words)
        migrated += int(kept.sum())
        dropped += int((~kept).sum())
        wbs_t[t] += int(dirty[~kept].sum())
        if t == 0:
            drop_dirty0 = addr[~kept & dirty]

    wbs = int(wbs_t.sum())
    flushed_bytes = wbs * BLOCK_BYTES
    # charge the flush on the carried stats (writeback DRAM traffic)
    e_dram = flush_energy_nJ_per_block(old_cfg)
    stats = Stats(*[np.array(x) for x in old.stats])
    stats = stats._replace(
        writebacks=stats.writebacks + wbs_t,
        dram_bytes=(stats.dram_bytes
                    + (wbs_t * BLOCK_BYTES).astype(np.float32)),
        energy_nJ=stats.energy_nJ + (wbs_t * e_dram).astype(np.float32))
    new = engine.state_from_numpy(
        new_cfg, EngineState(*host[:-2], stats=stats, pos=old.pos), dev)
    return new, HandoffReport(resident, migrated, dropped, wbs,
                              flushed_bytes, drop_dirty0)
