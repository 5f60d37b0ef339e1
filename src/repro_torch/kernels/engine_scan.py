"""Per-set cache-engine scan: hand-written CUDA kernels and their plain
PyTorch versions.

Replaces the Pallas bodies of ``src/repro/kernels/engine_scan.py``:

  * ``conv_scan`` <- ``_conv_scan_kernel`` (engine_scan.py:97) and its
    stateful twin ``_conv_state_kernel`` (:248);
  * ``ext_scan``  <- ``_ext_scan_kernel`` (:135) and ``_ext_state_kernel``
    (:283).

Each kernel (``csrc/engine_scan.cu``) gives one warp to one (trace, set)
and replays that set's L packed slots through the LRU tag store (and, on
the extended tier, the double-Bloom predictor and the BDI byte budget),
counting the per-request Stats.  Optional state rows in and out make the
monolithic scan and the epoch-carry scan one code path.

What bounds it on an H100: each set is a serial chain of dependent
steps, and a launch holds B*S of them, so its time follows the
instructions a step issues and the chains an SM keeps resident, not its
B*S*L*~11 input bytes over 3.35 TB/s.  The design keeps a step short:
an extended way is a tag and one packed word whose unsigned order is the
LRU victim order, so one warp min-reduction names the victim with its
dirty bit and size; the Bloom filters are spread over the lanes (one
word of each filter a lane, a chunk's Bloom masks in shared memory), so
one ballot answers both membership tests; the lookup, the victim and
the Bloom test are independent reductions issued together; the next 32
slots of the request columns load while this chunk replays.  Stats are
counted from a chunk's outcome bitmasks, and the float Stats formed from
the counts once a set (the same per-request constants the plain version
sums, equal within rounding).  The kernels take the rows the engine
makes (lru <= ``LRU_MAX``, sizes of 0, 32, 64 or 128 bytes, a tag valid
in at most one way of a set); ``check_row_contract`` holds state rows to
that before a launch.  ``launch_shape`` reports a launch's blocks, the
blocks an SM keeps resident and the waves.

Each wrapper checks device, dtype, shape and contiguity, and on CUDA the
state rows' contract.  On CUDA tensors it launches its kernel (and adds
one to ``launches``) or raises; on CPU tensors it runs the plain version
(``conv_scan_plain``/``ext_scan_plain``), which steps
``core.controller``'s set kernels over all (B, S) sets at once with a
Python loop over the L slots.  The plain versions take any rows, as the
reference's kernels do.  An active op counter (``roofline.op_cost``) is
charged each call's work by ``roofline.kernel_work.scan_work``, whichever
runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from ._build import supported  # noqa: F401  (engine.backend_status)
from ..core import controller as ctl
from ..core.controller import ConvRow, ExtRow, MorpheusConfig, Predictor, Stats
from ..core.compression import BLOCK_BYTES
from ..core.tag_store import LRU_MAX
from ..roofline import kernel_work, op_cost

# Stats layout of the kernels' outputs: one int32 and one float32 vector
# per set, in ``Stats`` field order.
INT_FIELDS: Tuple[str, ...] = tuple(
    f for f in Stats._fields if f in ctl._INT_FIELDS)
FLOAT_FIELDS: Tuple[str, ...] = tuple(
    f for f in Stats._fields if f not in ctl._INT_FIELDS)
_NI, _NF = len(INT_FIELDS), len(FLOAT_FIELDS)

# Launches of each CUDA kernel since the last ``reset_launches``, and
# runs of each plain version (which never count as launches).
launches: Dict[str, int] = {"conv_scan": 0, "ext_scan": 0}
plain_runs: Dict[str, int] = {"conv_scan": 0, "ext_scan": 0}

_PRED_CODE = {Predictor.BLOOM: 0, Predictor.NONE: 1, Predictor.PERFECT: 2}
_EXT_SIZES = (0, 32, 64, 128)
_MAX_CONV_WAYS = 32
_MAX_EXT_WAYS = 256


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        plain_runs[k] = 0


def stats_to_vecs(s: Stats) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stats with (...) leaves -> ((..., NI) int32, (..., NF) float32)."""
    ints = torch.stack([getattr(s, f).to(torch.int32) for f in INT_FIELDS],
                       dim=-1)
    flts = torch.stack([getattr(s, f).to(torch.float32)
                        for f in FLOAT_FIELDS], dim=-1)
    return ints, flts


def vecs_to_stats(ints: torch.Tensor, flts: torch.Tensor) -> Stats:
    """(..., NI) int32 + (..., NF) float32 -> Stats with (...) leaves."""
    vals = {f: ints[..., i] for i, f in enumerate(INT_FIELDS)}
    vals.update({f: flts[..., i] for i, f in enumerate(FLOAT_FIELDS)})
    return Stats(**vals)


def _costs(cfg: MorpheusConfig):
    """The per-request cost constants as float32, rounded where the
    reference's float32 arithmetic rounds them."""
    c = cfg.costs
    lat = cfg.latencies()
    e_conv = BLOCK_BYTES * c.conv_llc.energy_pJ_per_B * 1e-3
    e_ext = BLOCK_BYTES * c.ext_llc.energy_pJ_per_B * 1e-3
    e_dram = BLOCK_BYTES * c.dram.energy_pJ_per_B * 1e-3
    e_ext_pm = np.float32(e_ext) * np.float32(0.05)
    vals = [np.float32(v) for v in (*lat, e_conv, e_ext, e_ext_pm, e_dram)]
    return (ctypes.c_float * len(vals))(*[float(v) for v in vals])


# ------------------------------------------------------------- checks

def _check_columns(cols: Dict[str, Tuple[torch.Tensor, torch.dtype]]):
    """The packed (B, S, L) request columns; returns (B, S, L, device)."""
    first = next(iter(cols.values()))[0]
    if first.dim() != 3:
        raise ValueError(f"request columns must be (B, S, L), got "
                         f"{tuple(first.shape)}")
    for name, (t, dt) in cols.items():
        _build.check(name, t, dt, first.shape, first.device)
    b, s, length = first.shape
    return b, s, length, first.device


def _check_rows(row, template, b: int, s: int, device: torch.device):
    for name, t, ref in zip(row._fields, row, template):
        _build.check(f"state.{name}", t, ref.dtype,
                     (b, s) + tuple(ref.shape), device)


def check_row_contract(tier: str, rows) -> None:
    """Raise ``ValueError`` unless the (B, S, W) state rows of ``tier``
    ("conv" or "ext") are rows the engine makes, which the CUDA kernels'
    packed way words assume: lru <= ``LRU_MAX`` as uint32, an extended
    size of 0, 32, 64 or 128 bytes, a tag valid in at most one way of a
    set.  One reduction a field and one host read; the message names the
    field and the first offending (b, s, way)."""
    lru = rows.lru.to(torch.int64) & 0xFFFFFFFF
    w = rows.tags.shape[-1]
    # each set's valid tags, sorted, with the invalid ways as distinct
    # negative sentinels: a tag valid in two ways gives equal neighbours
    way_ids = torch.arange(w, device=lru.device)
    key = torch.where(rows.valid, rows.tags.to(torch.int64) & 0xFFFFFFFF,
                      -1 - way_ids)
    srt = key.sort(dim=-1).values
    bad = {"lru": lru > LRU_MAX,
           "tags": (srt[..., 1:] == srt[..., :-1]).any(dim=-1)}
    if tier == "ext":
        sizes = torch.tensor(_EXT_SIZES, dtype=torch.int32, device=lru.device)
        bad["size"] = ~torch.isin(rows.size, sizes)
    found = torch.stack([m.any() for m in bad.values()]).tolist()
    for (field, mask), hit in zip(bad.items(), found):
        if not hit:
            continue
        b, s, *way = mask.nonzero()[0].tolist()
        if field == "tags":     # the second valid way of the first repeat
            t = key[b, s].tolist()
            way = [next(j for j in range(w) if t[j] >= 0 and t[j] in t[:j])]
            msg = f"tag {t[way[0]]} valid in two ways of a set"
        else:
            v = (lru if field == "lru" else rows.size)[b, s, way[0]]
            msg = f"{field} {int(v)} outside " + (
                f"0..{LRU_MAX}" if field == "lru" else str(_EXT_SIZES))
        raise ValueError(f"{tier} state row ({b}, {s}, way {way[0]}): {msg}"
                         f"; the CUDA scan takes the rows the engine makes")


def _zero_vecs(b: int, s: int, dev: torch.device):
    return (torch.zeros((b, s, _NI), dtype=torch.int32, device=dev),
            torch.zeros((b, s, _NF), dtype=torch.float32, device=dev))


def _select(a: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``where(a, new, old)`` with the (B, S) slot mask broadcast over the
    trailing dims of a row leaf."""
    return torch.where(a.view(a.shape + (1,) * (new.dim() - a.dim())),
                       new, old)


# ---------------------------------------------------- conventional tier

def conv_scan_plain(cfg: MorpheusConfig, tag, write, active, mask,
                    state: Optional[ConvRow] = None,
                    keep_state: bool = False):
    """Plain PyTorch version of ``conv_scan`` (same arguments)."""
    plain_runs["conv_scan"] += 1
    b, s, length = tag.shape
    row = state if state is not None else ctl.conv_row_zero(cfg, (b, s),
                                                            tag.device)
    acc = ctl.zero_stats((b, s), tag.device)
    none = torch.zeros((b, s), dtype=torch.bool, device=tag.device)
    for t in range(length):
        a = active[..., t]
        new_row, out = ctl.conv_set_kernel(cfg, row, tag[..., t],
                                           write[..., t])
        row = ConvRow(*[_select(a, n, o) for n, o in zip(new_row, row)])
        acc = ctl.add_stats(acc, ctl.request_stats(cfg, mask[..., t], out,
                                                   none, None))
    ints, flts = stats_to_vecs(acc)
    return ints, flts, (row if keep_state else None)


@op_cost.charged(lambda a: kernel_work.scan_work(
    "conv", (a["tag"], a["write"], a["active"]), a["cfg"].conv_ways,
    a["state"]))
def conv_scan(cfg: MorpheusConfig, tag: torch.Tensor, write: torch.Tensor,
              active: torch.Tensor, mask: torch.Tensor, *,
              state: Optional[ConvRow] = None, keep_state: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[ConvRow]]:
    """All conventional sets of a packed batch.

    tag (B, S, L) int32 (uint32 pattern); write/active/mask (B, S, L)
    bool, where mask = active & (pos >= warmup).  ``state`` holds the
    sets' rows at the start (None: cold sets); with ``keep_state`` the
    final rows are returned.  Returns ((B, S, NI) int32, (B, S, NF)
    float32, rows or None).
    """
    b, s, length, dev = _check_columns({
        "tag": (tag, torch.int32), "write": (write, torch.bool),
        "active": (active, torch.bool), "mask": (mask, torch.bool)})
    if state is not None:
        _check_rows(state, ctl.conv_row_zero(cfg), b, s, dev)
    if dev.type == "cpu":
        return conv_scan_plain(cfg, tag, write, active, mask, state,
                               keep_state)
    if dev.type != "cuda":
        raise ValueError(f"conv_scan: no kernel for device {dev}")
    if not 0 < cfg.conv_ways <= _MAX_CONV_WAYS:
        raise ValueError(f"conv_scan: conv_ways={cfg.conv_ways} outside "
                         f"1..{_MAX_CONV_WAYS}")
    if state is not None:
        check_row_contract("conv", state)
    if not (b * s and length):      # nothing to replay: no launch
        rows = state if state is not None else ctl.conv_row_zero(cfg, (b, s),
                                                                 dev)
        return (*_zero_vecs(b, s, dev), rows if keep_state else None)
    ints = torch.empty((b, s, _NI), dtype=torch.int32, device=dev)
    flts = torch.empty((b, s, _NF), dtype=torch.float32, device=dev)
    out = (ConvRow(*[torch.empty_like(x) for x in
                     ctl.conv_row_zero(cfg, (b, s), dev)])
           if keep_state else None)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().conv_scan_launch(
            ptr(tag), ptr(write), ptr(active), ptr(mask),
            b * s, length, cfg.conv_ways, _costs(cfg),
            *[ptr(x) for x in (state or (None,) * 4)],
            ptr(ints), ptr(flts),
            *[ptr(x) for x in (out or (None,) * 4)],
            _build.stream(dev))
    _build.raise_on(err, "conv_scan")
    launches["conv_scan"] += 1
    return ints, flts, out


# ------------------------------------------------------- extended tier

def ext_scan_plain(cfg: MorpheusConfig, tag, write, level, active, mask,
                   state: Optional[ExtRow] = None, keep_state: bool = False):
    """Plain PyTorch version of ``ext_scan`` (same arguments)."""
    plain_runs["ext_scan"] += 1
    b, s, length = tag.shape
    row = state if state is not None else ctl.ext_row_zero(cfg, (b, s),
                                                           tag.device)
    acc = ctl.zero_stats((b, s), tag.device)
    none = torch.zeros((b, s), dtype=torch.bool, device=tag.device)
    for t in range(length):
        a = active[..., t]
        new_row, out = ctl.ext_set_kernel(cfg, row, tag[..., t],
                                          write[..., t], level[..., t])
        row = ExtRow(*[_select(a, n, o) for n, o in zip(new_row, row)])
        acc = ctl.add_stats(acc, ctl.request_stats(cfg, none, None,
                                                   mask[..., t], out))
    ints, flts = stats_to_vecs(acc)
    return ints, flts, (row if keep_state else None)


@op_cost.charged(lambda a: kernel_work.scan_work(
    "ext", (a["tag"], a["write"], a["level"], a["active"]),
    a["cfg"].ext_max_ways, a["state"]))
def ext_scan(cfg: MorpheusConfig, tag: torch.Tensor, write: torch.Tensor,
             level: torch.Tensor, active: torch.Tensor, mask: torch.Tensor,
             *, state: Optional[ExtRow] = None, keep_state: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[ExtRow]]:
    """All extended sets of a packed batch: as ``conv_scan``, plus the
    (B, S, L) int32 BDI ``level`` column; ``state`` rows are
    ``controller.ExtRow`` leaves with (B, S) leading dims."""
    b, s, length, dev = _check_columns({
        "tag": (tag, torch.int32), "write": (write, torch.bool),
        "level": (level, torch.int32), "active": (active, torch.bool),
        "mask": (mask, torch.bool)})
    if state is not None:
        _check_rows(state, ctl.ext_row_zero(cfg), b, s, dev)
    if dev.type == "cpu":
        return ext_scan_plain(cfg, tag, write, level, active, mask, state,
                              keep_state)
    if dev.type != "cuda":
        raise ValueError(f"ext_scan: no kernel for device {dev}")
    if not 0 < cfg.ext_max_ways <= _MAX_EXT_WAYS:
        raise ValueError(f"ext_scan: ext_max_ways={cfg.ext_max_ways} "
                         f"outside 1..{_MAX_EXT_WAYS}")
    if state is not None:
        check_row_contract("ext", state)
    if not (b * s and length):      # nothing to replay: no launch
        rows = state if state is not None else ctl.ext_row_zero(cfg, (b, s),
                                                                dev)
        return (*_zero_vecs(b, s, dev), rows if keep_state else None)
    ints = torch.empty((b, s, _NI), dtype=torch.int32, device=dev)
    flts = torch.empty((b, s, _NF), dtype=torch.float32, device=dev)
    out = (ExtRow(*[torch.empty_like(x) for x in
                    ctl.ext_row_zero(cfg, (b, s), dev)])
           if keep_state else None)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().ext_scan_launch(
            ptr(tag), ptr(write), ptr(level), ptr(active),
            ptr(mask), b * s, length, cfg.ext_max_ways,
            cfg.ext_budget_bytes, cfg.ext_ways,
            _PRED_CODE[cfg.predictor], int(cfg.compression), _costs(cfg),
            *[ptr(x) for x in (state or (None,) * 9)],
            ptr(ints), ptr(flts),
            *[ptr(x) for x in (out or (None,) * 9)],
            _build.stream(dev))
    _build.raise_on(err, "ext_scan")
    launches["ext_scan"] += 1
    return ints, flts, out


# ---------------------------------------------------------- occupancy

def launch_shape(tier: str, ways: int, n_sets: int,
                 device: torch.device) -> Dict[str, float]:
    """The launch of ``conv_scan`` (``tier`` "conv") or ``ext_scan``
    ("ext") over ``n_sets`` sets of ``ways`` ways on ``device``: its
    blocks and threads a block, the blocks an SM keeps resident
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the card's SMs
    and the waves (blocks over resident blocks of all SMs)."""
    dev = torch.device(device)
    _build.require_cuda(dev, "launch_shape")
    out = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(dev):
        err = _lib().engine_scan_launch_shape(
            {"conv": 0, "ext": 1}[tier], ways, n_sets,
            *[ctypes.byref(x) for x in out])
    _build.raise_on(err, "engine_scan_launch_shape")
    blocks, threads, per_sm = (x.value for x in out)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(blocks=blocks, threads=threads,
                resident_blocks_per_sm=per_sm, sms=sms,
                waves=blocks / max(per_sm * sms, 1))


# ------------------------------------------------------------ binding

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/engine_scan.cu`` with its C signatures declared."""
    lib = _build.load("engine_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.POINTER(ctypes.c_float)
    lib.conv_scan_launch.argtypes = ([p] * 4 + [i] * 3 + [f] + [p] * 4
                                     + [p] * 2 + [p] * 4 + [p])
    lib.conv_scan_launch.restype = i
    lib.ext_scan_launch.argtypes = ([p] * 5 + [i] * 7 + [f] + [p] * 9
                                    + [p] * 2 + [p] * 9 + [p])
    lib.ext_scan_launch.restype = i
    lib.engine_scan_launch_shape.argtypes = [i] * 3 + [p] * 3
    lib.engine_scan_launch_shape.restype = i
    return lib
