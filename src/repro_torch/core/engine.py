"""Set-parallel batched simulation engine, after ``repro.core.engine``.

All mutable simulator state is keyed by cache set and the Stats are pure
per-request sums, so requests that map to different sets commute: the
simulation decomposes into independent per-set state machines.

  1. ``pack`` (numpy, on the host) partitions each trace by (tier, set)
     with a stable sort, so the in-set request order is kept, and lays the
     per-set subsequences out as padded dense (B, S, L) arrays with an
     activity mask.  Its arrays are identical to the reference's.
  2. ``_run_packed`` moves them to the device and runs each tier's
     per-set scan (``kernels.engine_scan``), optionally from and into an
     explicit carry, then sums the per-set Stats over sets (the floats
     in a fixed pairwise order, ``_set_sum``).
  3. ``simulate_batch`` / ``simulate_parallel`` / ``advance_packed`` are
     the public entry points.  Integer counters equal the serial oracle's
     exactly; float sums differ only by accumulation order (<= 1e-3
     relative).

Backends (``BACKENDS``): ``"cuda"``, the hand-written kernels of
``kernels/csrc/engine_scan.cu``, is the default and runs on CUDA tensors;
``"torch"``, the plain PyTorch version (vectorised over sets, a Python
loop over the L slots), runs only when the caller asks for the CPU with
``device="cpu"``.  The backend follows the tensors' device: nothing falls
back from one to the other.

Dtype convention: tags, LRU counters and Bloom words are int32 tensors
holding the uint32 bit pattern; valid and dirty bits are bool tensors
(one byte each, read by the kernels as ``uint8_t``).
``state_from_numpy``/``state_to_numpy`` convert an ``EngineState`` from
and to the reference's numpy dtypes (uint32, bool, int32, float32).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from . import controller as ctl
from .controller import MorpheusConfig, Stats
from ..kernels import engine_scan

BACKENDS = ("torch", "cuda")
_BACKEND_OF_DEVICE = {"cpu": "torch", "cuda": "cuda"}


class BackendError(RuntimeError):
    """Requested engine backend cannot run on this host."""


def backend_status(backend: str) -> Tuple[bool, str]:
    """(supported, human-readable detail) for an engine backend name."""
    if backend == "torch":
        return True, "plain PyTorch per-set loop (CPU tensors only)"
    if backend == "cuda":
        return engine_scan.supported()
    return False, f"unknown backend {backend!r}; choose from {BACKENDS}"


def resolve_backend(backend: str | None = None) -> str:
    """Validate a backend choice (None -> ``"cuda"``) or raise a
    ``BackendError`` whose message says what to do about it."""
    b = backend or "cuda"
    ok, detail = backend_status(b)
    if not ok:
        raise BackendError(
            f"engine backend {b!r} is unavailable on this host: {detail}. "
            f"Pass device='cpu' to run the plain PyTorch version.")
    return b


def resolve_device(device=None, *, meta: bool = False) -> torch.device:
    """The device an entry point runs on: None -> the CUDA card (raises
    ``BackendError`` without one); ``"cpu"`` -> the plain version;
    ``"meta"`` (shapes only, for the op counter) where the caller allows
    it with ``meta=True``, as the model does."""
    dev = torch.device("cuda" if device is None else device)
    if meta and dev.type == "meta":
        return dev
    if dev.type not in _BACKEND_OF_DEVICE:
        raise BackendError(f"no engine backend for device {dev}; use "
                           f"'cuda' or 'cpu'")
    resolve_backend(_BACKEND_OF_DEVICE[dev.type])
    return dev


class PackedTraces(NamedTuple):
    """A batch of traces partitioned by (tier, set) and padded.

    Leading dims: B traces x S sets x L padded subsequence slots.  A slot
    with ``active == False`` is padding and is a no-op in the engine.
    ``pack`` returns numpy arrays; ``to_device`` the same fields as
    tensors (tags as int32 bit patterns).
    """
    conv_tag: np.ndarray      # (B, Sc, Lc) uint32
    conv_write: np.ndarray    # (B, Sc, Lc) bool
    conv_pos: np.ndarray      # (B, Sc, Lc) int32: original trace position
    conv_active: np.ndarray   # (B, Sc, Lc) bool
    ext_tag: np.ndarray       # (B, Se, Le) uint32
    ext_write: np.ndarray     # (B, Se, Le) bool
    ext_level: np.ndarray     # (B, Se, Le) int32
    ext_pos: np.ndarray       # (B, Se, Le) int32
    ext_active: np.ndarray    # (B, Se, Le) bool
    warmup: np.ndarray        # (B,) int32


def _bucket(n: int, minimum: int = 16) -> int:
    """Round a padded length up to a power of two."""
    if n <= minimum:
        return minimum
    return 1 << (int(n) - 1).bit_length()


def _dense_layout(set_idx: np.ndarray, n_sets: int, length: int,
                  cols: Sequence[np.ndarray]
                  ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Scatter per-request columns into (n_sets, length) padded arrays,
    preserving the original order within each set (stable sort)."""
    order = np.argsort(set_idx, kind="stable")
    ss = set_idx[order]
    starts = np.searchsorted(ss, np.arange(n_sets))
    slot = np.arange(len(ss)) - starts[ss]
    active = np.zeros((n_sets, length), bool)
    active[ss, slot] = True
    out = []
    for v in cols:
        a = np.zeros((n_sets, length), v.dtype)
        a[ss, slot] = v[order]
        out.append(a)
    return active, out


_UNCOUNTED_POS = np.int32(-(1 << 30))


def pack(cfg: MorpheusConfig,
         traces: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
         pos0: Sequence[int] | None = None,
         count: Sequence[np.ndarray | None] | None = None) -> PackedTraces:
    """Partition a batch of (addrs, writes, levels, warmup) traces.

    ``pos0`` (per trace, default 0) offsets the recorded positions, so an
    epoch of a stream packs with the same global positions, and hence the
    same ``pos >= warmup`` stats mask, as one monolithic pack.  ``count``
    (per-trace bool mask or None) marks requests that replay but are left
    out of the Stats: their position is recorded as a large negative
    number.
    """
    amap = cfg.amap
    total = max(amap.total_sets, 1)
    sc, se = amap.conv_sets, amap.ext_sets
    prepped = []
    max_c = max_e = 0
    for i, (addrs, writes, levels, warmup) in enumerate(traces):
        addrs = np.asarray(addrs, np.uint32)
        writes = np.asarray(writes, bool)
        levels = np.asarray(levels, np.int32)
        gset = (addrs % np.uint32(total)).astype(np.int64)
        tag = (addrs // np.uint32(total)).astype(np.uint32)
        off = int(pos0[i]) if pos0 is not None else 0
        pos = off + np.arange(len(addrs), dtype=np.int32)
        if count is not None and count[i] is not None:
            mask = np.asarray(count[i], bool)
            if mask.shape != addrs.shape:
                raise ValueError("count mask length mismatch")
            pos = np.where(mask, pos, _UNCOUNTED_POS)
        is_ext = gset >= sc if cfg.ext_enabled else np.zeros(len(addrs), bool)
        if sc:
            cnt = np.bincount(gset[~is_ext], minlength=sc)
            max_c = max(max_c, int(cnt.max()) if cnt.size else 0)
        if se:
            cnt = np.bincount(gset[is_ext] - sc, minlength=se)
            max_e = max(max_e, int(cnt.max()) if cnt.size else 0)
        prepped.append((gset, tag, pos, is_ext, writes, levels, int(warmup)))

    lc = _bucket(max_c) if sc and max_c else 0
    le = _bucket(max_e) if se and max_e else 0
    b = len(traces)
    conv = [np.zeros((b, sc, lc), dt) for dt in
            (np.uint32, bool, np.int32, bool)]
    ext = [np.zeros((b, se, le), dt) for dt in
           (np.uint32, bool, np.int32, np.int32, bool)]
    warmups = np.zeros((b,), np.int32)
    for i, (gset, tag, pos, is_ext, writes, levels, warmup) in \
            enumerate(prepped):
        warmups[i] = warmup
        if lc:
            keep = ~is_ext
            act, (t, w, p) = _dense_layout(
                gset[keep], sc, lc, (tag[keep], writes[keep], pos[keep]))
            conv[0][i], conv[1][i], conv[2][i], conv[3][i] = t, w, p, act
        if le:
            keep = is_ext
            act, (t, w, l, p) = _dense_layout(
                gset[keep] - sc, se, le,
                (tag[keep], writes[keep], levels[keep], pos[keep]))
            (ext[0][i], ext[1][i], ext[2][i],
             ext[3][i], ext[4][i]) = t, w, l, p, act
    return PackedTraces(conv[0], conv[1], conv[2], conv[3],
                        ext[0], ext[1], ext[2], ext[3], ext[4], warmups)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_device(pt: PackedTraces, device) -> PackedTraces:
    """The packed arrays as tensors on ``device`` (uint32 -> int32)."""
    dev = torch.device(device)
    return PackedTraces(*[_tensor(a, dev) for a in pt])


# ------------------------------------------------------------------ state

class EngineState(NamedTuple):
    """The packed engine's full carry for a batch of B traces: both tiers'
    rows, the extended tier's byte budgets and double Bloom filters, the
    accumulated Stats and the stream position."""
    conv_tags: torch.Tensor    # (B, Sc, Wc) int32 (uint32 pattern)
    conv_valid: torch.Tensor   # (B, Sc, Wc) bool
    conv_dirty: torch.Tensor   # (B, Sc, Wc) bool
    conv_lru: torch.Tensor     # (B, Sc, Wc) int32 (uint32 pattern)
    ext_tags: torch.Tensor     # (B, Se, We) int32 (uint32 pattern)
    ext_valid: torch.Tensor    # (B, Se, We) bool
    ext_dirty: torch.Tensor    # (B, Se, We) bool
    ext_lru: torch.Tensor      # (B, Se, We) int32 (uint32 pattern)
    ext_size: torch.Tensor     # (B, Se, We) int32 physical bytes per block
    ext_used: torch.Tensor     # (B, Se) int32 bytes in use
    bf1: torch.Tensor          # (B, Se, words) int32 (uint32 pattern)
    bf2: torch.Tensor          # (B, Se, words) int32 (uint32 pattern)
    n_mru: torch.Tensor        # (B, Se) int32
    stats: Stats               # accumulated, (B,) leaves
    pos: torch.Tensor          # (B,) int32: requests consumed so far


_CONV_FIELDS = ("conv_tags", "conv_valid", "conv_dirty", "conv_lru")
_EXT_FIELDS = ("ext_tags", "ext_valid", "ext_dirty", "ext_lru", "ext_size",
               "ext_used", "bf1", "bf2", "n_mru")
_U32_FIELDS = ("conv_tags", "conv_lru", "ext_tags", "ext_lru", "bf1", "bf2")


def init_state(cfg: MorpheusConfig, batch: int = 1,
               device=None) -> EngineState:
    """Cold engine state (empty caches, zero stats) for ``batch`` traces."""
    dev = resolve_device(device)
    conv = ctl.conv_row_zero(cfg, (batch, cfg.amap.conv_sets), dev)
    ext = ctl.ext_row_zero(cfg, (batch, cfg.amap.ext_sets), dev)
    return EngineState(*conv, *ext, stats=ctl.zero_stats((batch,), dev),
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=dev))


def state_from_numpy(cfg: MorpheusConfig, arrays, device=None
                     ) -> EngineState:
    """An ``EngineState`` from numpy arrays in the reference's layout and
    dtypes (e.g. the reference's state after ``np.asarray`` on every
    leaf): any object with the ``EngineState`` field names as attributes
    and a ``stats`` with the ``Stats`` field names."""
    dev = resolve_device(device)
    b = np.asarray(arrays.pos).shape[0]
    want = {"conv_tags": (b, cfg.amap.conv_sets, cfg.conv_ways),
            "ext_tags": (b, cfg.amap.ext_sets, cfg.ext_max_ways)}
    for f, shape in want.items():
        if tuple(np.shape(getattr(arrays, f))) != shape:
            raise ValueError(f"{f} has shape {np.shape(getattr(arrays, f))}"
                             f", config needs {shape}")

    def conv(a, dtype):
        a = np.array(a)                # a writable copy
        if dtype is torch.int32 and a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(dev, dtype)

    leaves = {}
    for f in EngineState._fields:
        if f == "stats":
            continue
        dt = torch.bool if f.endswith(("valid", "dirty")) else torch.int32
        leaves[f] = conv(getattr(arrays, f), dt)
    stats = Stats(**{
        f: conv(getattr(arrays.stats, f), torch.int32 if f in ctl._INT_FIELDS
                else torch.float32) for f in Stats._fields})
    return EngineState(stats=stats, **leaves)


def state_to_numpy(state: EngineState) -> EngineState:
    """The state as numpy arrays in the reference's dtypes: uint32 tags,
    LRU counters and Bloom words, bool valid/dirty, int32 elsewhere."""
    out = {}
    for f in EngineState._fields:
        if f == "stats":
            continue
        a = getattr(state, f).cpu().numpy()
        out[f] = a.view(np.uint32) if f in _U32_FIELDS else a
    stats = Stats(*[x.cpu().numpy() for x in state.stats])
    return EngineState(stats=stats, **out)


def decode_state(cfg: MorpheusConfig, state: EngineState,
                 trace: int = 0) -> dict:
    """Read-only host-side decode of one trace row's cache contents:
    per-set valid-way counts per tier, dirty-block totals, recovered block
    addresses (``addr = tag * total_sets + global_set``), extended-tier
    byte usage and per-resident sizes, the BF1 words and the position."""
    st = state_to_numpy(state)
    total = max(cfg.amap.total_sets, 1)

    conv_valid = st.conv_valid[trace]
    s_idx, w_idx = np.nonzero(conv_valid)
    conv_addr = (st.conv_tags[trace][s_idx, w_idx].astype(np.uint64)
                 * total + s_idx.astype(np.uint64))

    ext_valid = st.ext_valid[trace]
    e_s, e_w = np.nonzero(ext_valid)
    gset = (cfg.amap.conv_sets + e_s).astype(np.uint64)
    ext_addr = (st.ext_tags[trace][e_s, e_w].astype(np.uint64)
                * total + gset)

    return {
        "pos": int(st.pos[trace]),
        "conv_set_occ": conv_valid.sum(axis=1).astype(np.int64),
        "conv_dirty_blocks": int(st.conv_dirty[trace][s_idx, w_idx].sum()),
        "conv_addr": conv_addr,
        "ext_set_occ": ext_valid.sum(axis=1).astype(np.int64),
        "ext_dirty_blocks": int(st.ext_dirty[trace][e_s, e_w].sum()),
        "ext_addr": ext_addr,
        "ext_size_valid": st.ext_size[trace][e_s, e_w].astype(np.int64),
        "ext_used": st.ext_used[trace].astype(np.int64),
        "bf1": st.bf1[trace],
    }


# ------------------------------------------------------------------ engine

def _set_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, S, N) -> (B, N): the sum over the sets in one fixed pairwise
    order (zero-padded to a power of two, halves added), so a row's
    float sums do not depend on B or on the device's reduction plan: a
    replica's floats are the same in a fleet group as alone."""
    s = x.shape[1]
    width = 1 << max(s - 1, 0).bit_length()
    if width != s:
        x = torch.nn.functional.pad(x, (0, 0, 0, width - s))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def _run_packed(cfg: MorpheusConfig, pt: PackedTraces,
                state: EngineState | None = None
                ) -> Tuple[Stats, EngineState | None]:
    """Batched engine on device tensors: PackedTraces -> (Stats with (B,)
    leaves, the new state's rows or None).  ``state=None`` starts every
    set cold and drops the final rows; otherwise the rows are carried in
    and out (stats and pos are left to the caller)."""
    b = pt.warmup.shape[0]
    dev = pt.warmup.device
    ints = torch.zeros((b, len(engine_scan.INT_FIELDS)), dtype=torch.int32,
                       device=dev)
    flts = torch.zeros((b, len(engine_scan.FLOAT_FIELDS)),
                       dtype=torch.float32, device=dev)
    warm = pt.warmup[:, None, None]
    keep = state is not None
    if pt.conv_tag.shape[1] and pt.conv_tag.shape[2]:
        mask = pt.conv_active & (pt.conv_pos >= warm)
        rows0 = (ctl.ConvRow(*[getattr(state, f) for f in _CONV_FIELDS])
                 if keep else None)
        iv, fv, rows = engine_scan.conv_scan(
            cfg, pt.conv_tag, pt.conv_write, pt.conv_active, mask,
            state=rows0, keep_state=keep)
        ints += iv.sum(dim=1)
        flts += _set_sum(fv)
        if keep:
            state = state._replace(**dict(zip(_CONV_FIELDS, rows)))
    if pt.ext_tag.shape[1] and pt.ext_tag.shape[2]:
        mask = pt.ext_active & (pt.ext_pos >= warm)
        rows0 = (ctl.ExtRow(*[getattr(state, f) for f in _EXT_FIELDS])
                 if keep else None)
        iv, fv, rows = engine_scan.ext_scan(
            cfg, pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active, mask,
            state=rows0, keep_state=keep)
        ints += iv.sum(dim=1)
        flts += _set_sum(fv)
        if keep:
            state = state._replace(**dict(zip(_EXT_FIELDS, rows)))
    return engine_scan.vecs_to_stats(ints, flts), state


def advance_packed(cfg: MorpheusConfig, pt: PackedTraces, state: EngineState,
                   device=None) -> Tuple[EngineState, Stats]:
    """Apply one packed epoch (numpy, from ``pack``, or tensors already on
    ``device``, from ``to_device``) to an ``EngineState`` on ``device``;
    returns (new state, this epoch's Stats delta).

    The slice must continue where ``state`` left off (pack with ``pos0 =
    state.pos``): integer Stats accumulated over any epoch partition are
    then identical to one monolithic ``simulate_batch``."""
    dev = resolve_device(device)
    if state.pos.device.type != dev.type:
        raise ValueError(f"state lies on {state.pos.device}, not {dev}")
    obs.count("engine_dispatches", 1, path="epoch")
    tp = pt if isinstance(pt.warmup, torch.Tensor) else to_device(pt, dev)
    return _run_packed_state(cfg, tp, state)


def _run_packed_state(cfg: MorpheusConfig, pt: PackedTraces,
                      state: EngineState) -> Tuple[EngineState, Stats]:
    """Stateful engine on device tensors: one packed epoch (tensors on the
    state's device) applied to an explicit carry, its Stats and position
    advanced.  Returns (new state, this epoch's Stats delta).  The fleet
    calls it on a group's concatenated rows; it counts no dispatch."""
    delta, state = _run_packed(cfg, pt, state)
    n_req = (pt.conv_active.sum(dim=(1, 2)) + pt.ext_active.sum(dim=(1, 2))
             ).to(torch.int32)
    state = state._replace(stats=ctl.add_stats(state.stats, delta),
                           pos=state.pos + n_req)
    return state, delta


def simulate_batch(cfg: MorpheusConfig,
                   traces: Sequence[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, int]],
                   device=None) -> Stats:
    """Simulate a batch of traces under ONE config in one dispatch per
    tier.  Returns Stats with (B,) leaves on ``device``, in trace order."""
    dev = resolve_device(device)
    obs.count("engine_dispatches", 1, path="batch")
    stats, _ = _run_packed(cfg, to_device(pack(cfg, traces), dev))
    return stats


def simulate_parallel(cfg: MorpheusConfig, addrs, writes, levels,
                      warmup: int = 0, device=None) -> Stats:
    """Set-parallel counterpart of ``controller.simulate`` (0-d leaves)."""
    out = simulate_batch(cfg, [(addrs, writes, levels, warmup)], device)
    return Stats(*[x[0] for x in out])
