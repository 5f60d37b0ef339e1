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
summing the per-request Stats in in-set order.  Optional state rows in
and out make the monolithic scan and the epoch-carry scan one code path.

What bounds it on an H100: each set is a serial chain of L dependent
steps, so a launch costs about L step latencies (ballots, a warp
min-reduction, shuffles) rather than its B*S*L*~11 input bytes over
3.35 TB/s.  The design keeps every step in registers, loads the request
columns 32 slots at a time with one coalesced load per lane, skips
padding slots with a ballot, and puts 4 warps in a block so an SM holds
many independent chains to hide each step's latency.

Each wrapper checks device, dtype, shape and contiguity.  On CUDA tensors
it launches its kernel (and adds one to ``launches``) or raises; on CPU
tensors it runs the plain version (``conv_scan_plain``/``ext_scan_plain``),
which steps ``core.controller``'s set kernels over all (B, S) sets at once
with a Python loop over the L slots.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from ..core import controller as ctl
from ..core.controller import ConvRow, ExtRow, MorpheusConfig, Predictor, Stats
from ..core.compression import BLOCK_BYTES

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


def supported() -> Tuple[bool, str]:
    """Whether the CUDA kernels can run on this host, and how."""
    if not torch.cuda.is_available():
        return False, "torch.cuda.is_available() is False"
    return True, ("hand-written sm_90a kernels on "
                  f"{torch.cuda.get_device_name(0)}")


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

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_columns(cols: Dict[str, Tuple[torch.Tensor, torch.dtype]]):
    """The packed (B, S, L) request columns; returns (B, S, L, device)."""
    first = next(iter(cols.values()))[0]
    if first.dim() != 3:
        raise ValueError(f"request columns must be (B, S, L), got "
                         f"{tuple(first.shape)}")
    for name, (t, dt) in cols.items():
        _check(name, t, dt, first.shape, first.device)
    b, s, length = first.shape
    return b, s, length, first.device


def _check_rows(row, template, b: int, s: int, device: torch.device):
    for name, t, ref in zip(row._fields, row, template):
        _check(f"state.{name}", t, ref.dtype, (b, s) + tuple(ref.shape),
               device)


def _zero_vecs(b: int, s: int, dev: torch.device):
    return (torch.zeros((b, s, _NI), dtype=torch.int32, device=dev),
            torch.zeros((b, s, _NF), dtype=torch.float32, device=dev))


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


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
    if not (b * s and length):      # nothing to replay: no launch
        rows = state if state is not None else ctl.conv_row_zero(cfg, (b, s),
                                                                 dev)
        return (*_zero_vecs(b, s, dev), rows if keep_state else None)
    ints = torch.empty((b, s, _NI), dtype=torch.int32, device=dev)
    flts = torch.empty((b, s, _NF), dtype=torch.float32, device=dev)
    out = (ConvRow(*[torch.empty_like(x) for x in
                     ctl.conv_row_zero(cfg, (b, s), dev)])
           if keep_state else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().conv_scan_launch(
            _ptr(tag), _ptr(write), _ptr(active), _ptr(mask),
            b * s, length, cfg.conv_ways, _costs(cfg),
            *[_ptr(x) for x in (state or (None,) * 4)],
            _ptr(ints), _ptr(flts),
            *[_ptr(x) for x in (out or (None,) * 4)],
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"conv_scan kernel launch failed: CUDA error "
                           f"{err}")
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
    if not (b * s and length):      # nothing to replay: no launch
        rows = state if state is not None else ctl.ext_row_zero(cfg, (b, s),
                                                                dev)
        return (*_zero_vecs(b, s, dev), rows if keep_state else None)
    ints = torch.empty((b, s, _NI), dtype=torch.int32, device=dev)
    flts = torch.empty((b, s, _NF), dtype=torch.float32, device=dev)
    out = (ExtRow(*[torch.empty_like(x) for x in
                    ctl.ext_row_zero(cfg, (b, s), dev)])
           if keep_state else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ext_scan_launch(
            _ptr(tag), _ptr(write), _ptr(level), _ptr(active),
            _ptr(mask), b * s, length, cfg.ext_max_ways,
            cfg.ext_budget_bytes, cfg.ext_ways,
            _PRED_CODE[cfg.predictor], int(cfg.compression), _costs(cfg),
            *[_ptr(x) for x in (state or (None,) * 9)],
            _ptr(ints), _ptr(flts),
            *[_ptr(x) for x in (out or (None,) * 9)],
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ext_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches["ext_scan"] += 1
    return ints, flts, out


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
    return lib
