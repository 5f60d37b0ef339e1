"""File-backed ``.npz`` trace corpus: import / export / validate (a
numpy-only copy of ``repro.workloads.corpus``: a file either package
writes, the other reads).

A corpus file holds one LLC access trace in the exact representation the
engine consumes — block addresses, write flags, BDI compressibility
levels — plus a small metadata record, so externally captured memory
traces (or expensive synthetic ones) can be replayed bit-identically
across sessions and machines.

Format (``np.savez``, schema_version 1):

  addrs    uint32 (N,)   block addresses (addr = byte_addr // 128)
  writes   bool   (N,)   write flag per access
  levels   int32  (N,)   BDI level per access (0 HIGH / 1 LOW / 2 UNCOMP)
  meta     unicode json   {"schema": 1, "name", "like", "n_cores",
                           "seed", "ws_scale", "extra": {...}}

``like`` names the synthetic app profile whose analytical parameters
(instructions per access, DRAM contention knee) the system model should
assume when replaying this trace — external traces carry no arithmetic-
intensity information of their own, so the replayer needs a declared
profile (default "cfd", a middle-of-the-road memory-bound app).

``tools/trace_corpus.py`` is the CLI over this module (export a synthetic
source into a corpus file, validate, show info).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SCHEMA_VERSION = 1
_LEVELS = (0, 1, 2)     # compression.HIGH / LOW / UNCOMP


def save_trace(path: str | Path, addrs, writes, levels, *,
               name: str = "trace", like: str = "cfd",
               n_cores: int = 0, seed: int = 0, ws_scale: float = 1.0,
               extra: Dict | None = None) -> Path:
    """Write one trace (plus metadata) to an ``.npz`` corpus file."""
    addrs = np.asarray(addrs, np.uint32)
    writes = np.asarray(writes, bool)
    levels = np.asarray(levels, np.int32)
    if not (len(addrs) == len(writes) == len(levels)):
        raise ValueError(
            f"column length mismatch: addrs {len(addrs)} / writes "
            f"{len(writes)} / levels {len(levels)}")
    meta = {"schema": SCHEMA_VERSION, "name": name, "like": like,
            "n_cores": int(n_cores), "seed": int(seed),
            "ws_scale": float(ws_scale), "extra": extra or {}}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, addrs=addrs, writes=writes, levels=levels,
             meta=np.str_(json.dumps(meta)))
    return path


def load_trace(path: str | Path
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
    """Load a corpus file -> (addrs, writes, levels, meta).  Validates on
    the way in: a malformed file raises ``ValueError`` immediately rather
    than producing garbage Stats later."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as z:
        missing = {"addrs", "writes", "levels", "meta"} - set(z.files)
        if missing:
            raise ValueError(f"{path}: not a trace corpus file "
                             f"(missing keys {sorted(missing)})")
        addrs = z["addrs"]
        writes = z["writes"]
        levels = z["levels"]
        meta = json.loads(str(z["meta"]))
    errors = validate_arrays(addrs, writes, levels, meta)
    if errors:
        raise ValueError(f"{path}: invalid corpus: " + "; ".join(errors))
    return addrs, writes, levels, meta


def validate_arrays(addrs, writes, levels, meta: Dict) -> list:
    """Schema/dtype/value checks; returns a list of problems (empty=ok)."""
    errors = []
    if meta.get("schema") != SCHEMA_VERSION:
        errors.append(f"schema {meta.get('schema')!r} != {SCHEMA_VERSION}")
    if addrs.dtype != np.uint32:
        errors.append(f"addrs dtype {addrs.dtype} != uint32")
    if writes.dtype != np.bool_:
        errors.append(f"writes dtype {writes.dtype} != bool")
    if levels.dtype != np.int32:
        errors.append(f"levels dtype {levels.dtype} != int32")
    if not (addrs.shape == writes.shape == levels.shape) or addrs.ndim != 1:
        errors.append(f"shape mismatch: {addrs.shape}/{writes.shape}/"
                      f"{levels.shape} (want equal 1-D)")
    if len(addrs) == 0:
        errors.append("empty trace")
    if levels.size and not np.isin(levels, _LEVELS).all():
        bad = sorted(set(np.unique(levels).tolist()) - set(_LEVELS))
        errors.append(f"levels outside {_LEVELS}: {bad}")
    return errors


def validate_trace(path: str | Path) -> list:
    """Validate a corpus file on disk; returns problems (empty = clean)."""
    try:
        load_trace(path)
    except ValueError as e:
        return [str(e)]
    except Exception as e:          # unreadable / not an npz at all
        return [f"{path}: unreadable ({type(e).__name__}: {e})"]
    return []


def trace_info(path: str | Path) -> Dict:
    """Summary of a corpus file: metadata + basic trace statistics."""
    addrs, writes, levels, meta = load_trace(path)
    return {
        **meta,
        "length": int(len(addrs)),
        "unique_blocks": int(len(np.unique(addrs))),
        "footprint_MiB": len(np.unique(addrs)) * 128 / (1 << 20),
        "write_frac": float(writes.mean()),
        "level_mix": {lv: float((levels == lv).mean()) for lv in _LEVELS},
    }
