"""The program's own spans (``repro_torch.obs``, docs/observability.md),
read where a run turns the program's tracing on (``perfbench/spans.py``):
the tracer's records as plain dicts, and the reductions of their tree
that the program-span readings take.

A span is a dict: ``name``, ``t0`` and ``t1`` (integer ns of the
tracer's clock), ``id``, ``parent`` (the id of the span open around it,
or None), ``tags`` and ``device_ms`` (the device time between its device
edges, or None).  Every reduction returns None where the spans hold
nothing to read: a program that records none of them, or a cell without
the layer."""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional

Span = dict


def collect(tracer) -> List[Span]:
    """The closed spans of the program's ``tracer`` (after the caller's
    synchronise: device edges are read here); none from a tracer that
    keeps no records, or from no tracer."""
    return [{"name": r.name, "t0": r.t0, "t1": r.t1, "id": r.id,
             "parent": r.parent, "tags": r.tags, "device_ms": r.device_ms()}
            for r in getattr(tracer, "records", None) or []]


def intervals(spans: List[Span]) -> List[tuple]:
    """(name, t0, t1) of each span: ``DeviceTrace.summary``'s input."""
    return [(s["name"], s["t0"], s["t1"]) for s in spans]


def _above(spans: List[Span]) -> Callable[[Span, str], Optional[Span]]:
    ids = {s["id"]: s for s in spans}

    def above(s: Span, name: str) -> Optional[Span]:
        while s["parent"] is not None and s["parent"] in ids:
            s = ids[s["parent"]]
            if s["name"] == name:
                return s
        return None
    return above


def _per(spans: List[Span], under: str, name: str,
         value: Callable[[Span], float]) -> Optional[float]:
    """The sum of ``value`` over the spans ``name`` with a span ``under``
    above them, over the spans ``under``."""
    above = _above(spans)
    outer = {s["id"] for s in spans if s["name"] == under}
    got = [value(s) for s in spans if s["name"] == name
           and (a := above(s, under)) is not None and a["id"] in outer]
    if not outer or not got:
        return None
    return sum(got) / len(outer)


def _host_ms(s: Span) -> float:
    return (s["t1"] - s["t0"]) / 1e6


def moe_dispatch_ms(spans: List[Span]) -> Optional[float]:
    """Host ms in the MoE layer (``moe.dispatch``) a decode step."""
    return _per(spans, "lm.decode_step", "moe.dispatch", _host_ms)


def decode_step_ms(spans: List[Span]) -> Optional[float]:
    """Host ms of a decode step (``lm.decode_step``)."""
    got = [_host_ms(s) for s in spans if s["name"] == "lm.decode_step"]
    return sum(got) / len(got) if got else None


def expert_segments_per_step(spans: List[Span]) -> Optional[float]:
    """Experts run (``moe.experts``' ``segments``) a decode step, summed
    over the MoE layers."""
    return _per(spans, "lm.decode_step", "moe.experts",
                lambda s: s["tags"]["segments"])


def readbacks_per_step(spans: List[Span]) -> Optional[float]:
    """Reads of the device back to the host (``*.readback``) in an
    iteration of the engine's decode loop that ran a decode step."""
    above = _above(spans)
    ran = {a["id"] for s in spans if s["name"] == "lm.decode_step"
           and (a := above(s, "serve.decode_step")) is not None}
    reads: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s["name"].endswith(".readback"):
            a = above(s, "serve.decode_step")
            if a is not None and a["id"] in ran:
                reads[a["id"]] += 1
    if not ran:
        return None
    return sum(reads.values()) / len(ran)


def pool_readbacks_per_batch(spans: List[Span]) -> Optional[float]:
    """The page pool's reads of device state (``pool.readback``) in a
    batch's consultation (``serve.consult``)."""
    return _per(spans, "serve.consult", "pool.readback", lambda s: 1)


def phase_ms(spans: List[Span], phase: str) -> Optional[float]:
    """Device ms of a train step's phase (``train.forward``,
    ``train.backward``, ``train.optimizer``) a step, from its device
    edges; None where any has none."""
    got = [s for s in spans if s["name"] == phase]
    if not got or any(s["device_ms"] is None for s in got):
        return None
    return _per(spans, "train.step", phase, lambda s: s["device_ms"])


def step_device_ms(spans: List[Span]) -> Optional[float]:
    """Device ms of a train step, from ``train.step``'s device edges."""
    got = [s["device_ms"] for s in spans if s["name"] == "train.step"]
    if not got or None in got:
        return None
    return sum(got) / len(got)


def self_ms(spans: List[Span]) -> Dict[str, float]:
    """Host ms by span name of each span's time less its children's."""
    child: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] += s["t1"] - s["t0"]
    out: Dict[str, float] = defaultdict(float)
    for s in spans:
        out[s["name"]] += (s["t1"] - s["t0"] - child[s["id"]]) / 1e6
    return dict(out)


READINGS = {
    "moe_dispatch_ms": moe_dispatch_ms,
    "decode_step_ms": decode_step_ms,
    "expert_segments_per_step": expert_segments_per_step,
    "readbacks_per_step": readbacks_per_step,
    "pool_readbacks_per_batch": pool_readbacks_per_batch,
    "forward_ms": lambda s: phase_ms(s, "train.forward"),
    "backward_ms": lambda s: phase_ms(s, "train.backward"),
    "optimizer_ms": lambda s: phase_ms(s, "train.optimizer"),
    "step_device_ms": step_device_ms,
}


def readings(spans: List[Span]) -> Dict[str, float]:
    """Every reading above that the spans hold."""
    out = {k: f(spans) for k, f in READINGS.items()}
    return {k: v for k, v in out.items() if v is not None}
