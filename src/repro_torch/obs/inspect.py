"""Online cache-content introspection: decoded ``EngineState`` snapshots
(a copy of ``repro.obs.inspect``).

The cache microscope.  The engine's carry (tag rows, byte budgets, Bloom
words) is opaque at runtime; this module holds the *decoded* per-epoch
view — per-set/per-tier occupancy, valid/dirty fractions, byte-budget
utilization, the compression expansion factor, per-tenant residency
(owners recovered from block addresses), and the Bloom predictor's fill
ratio + measured false-positive rate — as plain host-side records.

Like the rest of ``obs`` this module imports nothing from the rest of
``repro_torch``: the decoders live next to the state they decode
(``core/engine.py::decode_state``, which hands over uint32 tags as
uint32, ``serving/paged_kv.py::introspect``)
and hand this module opaque numpy arrays plus scalar parameters.  The
instrumented sites pay one module-global ``None`` check when
introspection is off (``obs.inspector()``); snapshot decoding is pure
bookkeeping off the device hot path, so enabling it changes no simulator
number (tests/test_obs.py pins bit-identity on both backends).

Activation mirrors ``obs.metrics``: ``obs.enable(inspect=True)``
installs a process-global ``Inspector``; ``obs.inspector()`` is the
accessor every probe site guards on.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

SCHEMA = 1

_ACTIVE: Optional["Inspector"] = None


def activate(insp: "Inspector") -> "Inspector":
    global _ACTIVE
    _ACTIVE = insp
    return insp


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional["Inspector"]:
    return _ACTIVE


# ---------------------------------------------------------------- snapshot

@dataclass
class Snapshot:
    """One decoded cache-content observation (host-side, numpy-free)."""
    epoch: int
    pos: int                       # stream position at capture time
    replica: str = ""              # owning replica/stream label
    # per-set valid-way counts, tier by tier (lists so json round-trips)
    conv_set_occ: List[int] = field(default_factory=list)
    ext_set_occ: List[int] = field(default_factory=list)
    conv_occupancy: float = 0.0    # valid ways / total conv ways
    ext_occupancy: float = 0.0     # valid blocks / total ext way slots
    conv_dirty_frac: float = 0.0   # dirty / valid, conventional tier
    ext_dirty_frac: float = 0.0    # dirty / valid, extended tier
    byte_util: float = 0.0         # ext bytes used / ext byte budget
    expansion: float = 1.0         # logical bytes / physical bytes (BDI)
    bloom_fill: float = 0.0        # mean BF1 bit-fill ratio over sets
    bloom_fp_rate: float = 0.0     # cumulative measured FP rate
    residency: Dict[str, int] = field(default_factory=dict)  # owner->blocks

    def to_dict(self) -> Dict:
        return {
            "epoch": self.epoch, "pos": self.pos, "replica": self.replica,
            "conv_set_occ": list(self.conv_set_occ),
            "ext_set_occ": list(self.ext_set_occ),
            "conv_occupancy": self.conv_occupancy,
            "ext_occupancy": self.ext_occupancy,
            "conv_dirty_frac": self.conv_dirty_frac,
            "ext_dirty_frac": self.ext_dirty_frac,
            "byte_util": self.byte_util, "expansion": self.expansion,
            "bloom_fill": self.bloom_fill,
            "bloom_fp_rate": self.bloom_fp_rate,
            "residency": dict(self.residency),
        }


def bloom_fill_ratio(bf1) -> float:
    """Mean bit-fill ratio of the BF1 word array (sets, words) uint32."""
    bf1 = np.ascontiguousarray(np.asarray(bf1, np.uint32))
    if bf1.size == 0:
        return 0.0
    bits = np.unpackbits(bf1.view(np.uint8))
    return float(bits.mean())


def residency_by_owner(addrs, *, stride: int,
                       names: Optional[Sequence[str]] = None
                       ) -> Dict[str, int]:
    """Resident block counts per owner, recovered from block addresses
    (``owner = addr // stride`` — the composer's tenant tagging)."""
    addrs = np.asarray(addrs, np.uint64)
    out: Dict[str, int] = {}
    if len(addrs) == 0:
        return out
    owners = (addrs // np.uint64(max(stride, 1))).astype(np.int64)
    for k, n in zip(*np.unique(owners, return_counts=True)):
        label = names[int(k)] if names is not None and \
            0 <= int(k) < len(names) else f"t{int(k)}"
        out[label] = int(n)
    return out


def snapshot_from_decode(dec: Dict, *, epoch: int, replica: str = "",
                         conv_ways: int, ext_max_ways: int,
                         ext_budget_bytes: int, block_bytes: int,
                         tenant_stride: int = 0,
                         tenant_names: Optional[Sequence[str]] = None,
                         probe_counters=(0, 0)) -> Snapshot:
    """Build a ``Snapshot`` from a ``core/engine.py::decode_state`` dict.

    Everything arrives as opaque numpy arrays / scalars so this module
    stays import-pure.  ``probe_counters`` is the stream's cumulative
    (false positives, predicted misses) pair; ``tenant_stride`` of 0
    skips owner recovery (single-tenant raw traces)."""
    conv_occ = np.asarray(dec["conv_set_occ"], np.int64)
    ext_occ = np.asarray(dec["ext_set_occ"], np.int64)
    conv_valid = int(conv_occ.sum())
    ext_valid = int(ext_occ.sum())
    ext_used = np.asarray(dec["ext_used"], np.int64)
    n_ext_sets = len(ext_occ)
    budget_total = ext_budget_bytes * max(n_ext_sets, 1)
    phys = int(np.asarray(dec["ext_size_valid"], np.int64).sum())
    logical = ext_valid * block_bytes
    fp, pm = int(probe_counters[0]), int(probe_counters[1])
    residency: Dict[str, int] = {}
    if tenant_stride > 0:
        addrs = np.concatenate([np.asarray(dec["conv_addr"], np.uint64),
                                np.asarray(dec["ext_addr"], np.uint64)])
        residency = residency_by_owner(addrs, stride=tenant_stride,
                                       names=tenant_names)
    return Snapshot(
        epoch=int(epoch), pos=int(dec.get("pos", 0)), replica=replica,
        conv_set_occ=[int(x) for x in conv_occ],
        ext_set_occ=[int(x) for x in ext_occ],
        conv_occupancy=conv_valid / max(len(conv_occ) * conv_ways, 1),
        ext_occupancy=ext_valid / max(n_ext_sets * ext_max_ways, 1),
        conv_dirty_frac=int(dec["conv_dirty_blocks"]) / max(conv_valid, 1),
        ext_dirty_frac=int(dec["ext_dirty_blocks"]) / max(ext_valid, 1),
        byte_util=int(ext_used.sum()) / max(budget_total, 1),
        expansion=logical / phys if phys > 0 else 1.0,
        bloom_fill=bloom_fill_ratio(dec["bf1"]),
        bloom_fp_rate=fp / max(fp + pm, 1),
        residency=residency,
    )


# --------------------------------------------------------------- inspector

class Inspector:
    """Process-global snapshot collector (+ serving owner notes).

    ``every`` strides the capture (``wants(epoch)``); ``max_snapshots``
    bounds memory — past it new snapshots are counted as dropped, never
    silently truncated (``dropped`` lands in the export)."""

    def __init__(self, *, every: int = 1, max_snapshots: int = 4096):
        assert every >= 1
        self.every = int(every)
        self.max_snapshots = int(max_snapshots)
        self.snapshots: List[Snapshot] = []
        self.dropped = 0
        # serving-side page ownership: page keys carry no tenant bits, so
        # the engine notes key -> tenant at insert time and the pool's
        # decoder recovers residency through these notes
        self.owners: Dict[int, str] = {}

    def wants(self, epoch: int) -> bool:
        return epoch % self.every == 0

    def record(self, snap: Snapshot) -> None:
        if len(self.snapshots) >= self.max_snapshots:
            self.dropped += 1
            return
        self.snapshots.append(snap)

    def note_owner(self, key: int, owner: str) -> None:
        self.owners[int(key)] = owner

    def owner_of(self, key: int) -> str:
        return self.owners.get(int(key), "")

    # ------------------------------------------------------------ export
    def to_json(self) -> Dict:
        return {"schema": SCHEMA, "kind": "inspect",
                "dropped": self.dropped,
                "snapshots": [s.to_dict() for s in self.snapshots]}

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1) + "\n")
        return path


def load_inspect(path: str | Path) -> Dict:
    """Load + sanity-check an inspector export (raises ValueError on a
    file that is not an inspect bundle of a known schema)."""
    doc = json.loads(Path(path).read_text())
    if not isinstance(doc, dict) or doc.get("kind") != "inspect":
        raise ValueError(f"{path}: not an inspect bundle")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: unknown inspect schema "
                         f"{doc.get('schema')!r} (want {SCHEMA})")
    return doc
