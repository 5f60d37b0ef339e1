"""The op counter: FLOPs, bytes and collective traffic of a PyTorch
program, the port's counterpart of the reference's
``roofline/hlo_cost.py`` (which parses XLA's optimised HLO; no torch
program produces any).

``OpCounter`` is a ``TorchDispatchMode`` that charges each aten op it
sees, after autograd and the composite ops' decomposition, so a Python
loop over layers needs no trip count (each trip is dispatched) and the
backward and any recomputation under ``torch.utils.checkpoint`` are
counted as they run (XLA's rematerialised dots are counted too).
``analyze(fn, *args, **kw)`` runs ``fn`` under a counter and returns
its ``Cost``.  The rules follow hlo_cost's:

  * FLOPs: matmul-class ops only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``; einsum and ``@`` reach them), by the formulas of
    ``torch.utils.flop_counter.flop_registry``; hlo_cost counts dots
    only, and so does this;
  * bytes: each op is charged its tensor operands plus its outputs;
  * free: view and bookkeeping ops (``view``, ``_unsafe_view``, ``t``,
    ``transpose``, ``permute``, ``expand``, ``slice``, ``select``,
    ``unsqueeze``, ``squeeze``, ``alias``, ``detach``, ``as_strided``,
    every op whose outputs alias an input without writing it, and empty
    allocations), as hlo_cost's tuple, bitcast and parameter ops are;
  * an op that only writes (``zeros``, ``fill_``, ``arange``, ...) is
    charged its outputs;
  * a write of an update into a buffer (``copy_`` into a slice: the
    update read and the slice written; ``index_put_``,
    ``index_copy_``: twice the update's bytes) is charged by the update,
    not the buffer, as hlo_cost charges a dynamic-update-slice; a gather
    (``index``, ``index_select``, ``gather``, ``embedding``) twice the
    slice it reads, not the buffer;
  * collectives (``_c10d_functional.*``): their operand bytes under the
    reference's kind names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``), and
    their operands and outputs as bytes;
  * hand-written kernels: a launch through ctypes is invisible here, so
    each wrapper charges its function's work (``kernel_work``) through
    ``charge``, which suspends the counting of the ops inside it (the
    plain version's on the CPU, the kernel's buffers on the card, nothing
    on ``meta``).  A step counted on CPU tensors, on ``meta`` and on CUDA
    gives the same FLOPs and bytes.

DTensor programs (tensor parallelism, ``distributed.tensor_parallel``)
are counted per rank, as the reference's post-SPMD HLO is: an op on
DTensor arguments is passed on to DTensor's dispatch (the counter
declines it), which runs the rank's local ops and the redistributions'
``_c10d_functional`` collectives, and those reach the counter at local
shapes.  DTensor's sharding propagator also runs each new op once on
global-shape fake tensors to learn its output's metadata (and caches
it, so a step would count differently the first and the second time);
those runs are not the rank's work, and the counter is suspended while
they run (``_propagation_suspends``).

An eager program's bytes are not XLA's: nothing is fused, so every
intermediate is written and read again.  The count says what this
program moves, not what a fused one would.

Memory: ``Cost.argument_bytes`` and ``output_bytes`` are the tensors
passed to and returned by ``fn`` (distinct storages);
``temp_bytes`` is the peak of the intermediate bytes alive at once,
tracked from each op's fresh outputs to their release (on ``meta`` the
only source; ``analyze`` on CUDA tensors reads
``torch.cuda.max_memory_allocated`` above what was allocated at the
start instead).
"""
from __future__ import annotations

import functools
import inspect
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from .kernel_work import Work

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "isend": "collective-permute"}
_MATMUL = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
_FREE = (aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh, aten._local_scalar_dense,
         aten.scalar_tensor)
_WRITE_ONLY = (aten.zeros, aten.ones, aten.full, aten.zeros_like,
               aten.ones_like, aten.full_like, aten.new_zeros, aten.new_ones,
               aten.new_full, aten.arange, aten.fill_, aten.zero_,
               aten.normal_, aten.uniform_)
_GATHER = (aten.index, aten.index_select, aten.gather, aten.embedding)
# update operand of each indexed write, by position
_UPDATE_ARG = {aten.index_put_: 2, aten.index_put: 2,
               aten._index_put_impl_: 2, aten.index_copy_: 3,
               aten.index_copy: 3}
# OpCounters entered and not yet left, in any thread: while none is, a
# kernel wrapper's charge does nothing at all
_ACTIVE = 0
_ENTERED: List["OpCounter"] = []


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (what the rank holds), else ``t``."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _propagation_suspends(fn):
    """``fn`` (DTensor's global-shape metadata run) with every entered
    counter suspended."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        counters = list(_ENTERED)
        for c in counters:
            c._suspended += 1
        try:
            return fn(*args, **kwargs)
        finally:
            for c in counters:
                c._suspended -= 1
    run.suspends = True
    return run


if not getattr(ShardingPropagator._propagate_tensor_meta_non_cached,
               "suspends", False):
    ShardingPropagator._propagate_tensor_meta_non_cached = \
        _propagation_suspends(
            ShardingPropagator._propagate_tensor_meta_non_cached)


@dataclass
class Cost:
    """What a program costs, the reference's fields (``flops``,
    ``bytes``, ``collective_bytes``, ``collective_by_kind``) and the
    counter's own: ``collective_counts`` (ops by kind), ``by_name``
    (``name -> [calls, flops, bytes]``, an aten op by its packet, a
    kernel charge by its wrapper's name) and the memory sizes above."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    by_name: Dict[str, List[float]] = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    seconds: float = 0.0

    def add(self, name: str, flops: float = 0.0, nbytes: float = 0.0,
            kind: Optional[str] = None, coll: float = 0.0) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_name.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if kind is not None:
            self.collective_bytes += coll
            self.collective_by_kind[kind] = (
                self.collective_by_kind.get(kind, 0) + coll)
            self.collective_counts[kind] = (
                self.collective_counts.get(kind, 0) + 1)


class OpCounter(TorchDispatchMode):
    """A dispatch mode that charges every op to ``self.cost`` by the
    rules of the module docstring; ``charge`` reaches the counters on the
    current dispatch mode stack."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._suspended = 0
        self._lock = threading.Lock()
        self._live = 0
        self._peak = 0

    def __enter__(self):
        global _ACTIVE
        _ACTIVE += 1
        _ENTERED.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE -= 1
        _ENTERED.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ charging
    def _add(self, name: str, flops: float = 0.0, nbytes: float = 0.0,
             kind: Optional[str] = None, coll: float = 0.0) -> None:
        self.cost.add(name, flops, nbytes, kind, coll)

    def _charge_op(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(packet.__name__)
            if kind is not None:
                b = sum(_nbytes(t) for t in _tensors((args, kwargs)))
                self._add(kind, nbytes=b + sum(map(_nbytes, _tensors(out))),
                          kind=kind, coll=b)
            return
        if packet in _FREE:
            return
        name = str(packet)
        if packet in _MATMUL:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self._add(name, flops, sum(map(_nbytes, _tensors((args, kwargs,
                                                               out)))))
        elif packet in _WRITE_ONLY:
            self._add(name, nbytes=sum(map(_nbytes, _tensors(out))))
        elif packet is aten.copy_:
            self._add(name, nbytes=_nbytes(args[0]) + _nbytes(args[1]))
        elif packet in _UPDATE_ARG:
            self._add(name, nbytes=2 * _nbytes(args[_UPDATE_ARG[packet]]))
        elif packet in _GATHER:
            self._add(name, nbytes=2 * sum(map(_nbytes, _tensors(out))))
        elif not _aliases_only(func):
            self._add(name, nbytes=sum(map(_nbytes, _tensors((args, kwargs,
                                                               out)))))

    # ------------------------------------------------------------- memory
    def _track(self, func, out) -> None:
        """Count each fresh output (one that aliases no input) alive from
        now until its release."""
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if len(returns) == 1:                   # one Tensor or Tensor[]
            returns = returns * len(outs)
        for r, t in zip(returns, outs):
            if not isinstance(t, torch.Tensor) or r.alias_info is not None:
                continue
            n = t.untyped_storage().nbytes()
            with self._lock:
                self._live += n
                self._peak = max(self._peak, self._live)
            weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        with self._lock:
            self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor's dispatch: local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspended:
            self._charge_op(func, args, kwargs, out)
        self._track(func, out)
        return out


def _aliases_only(func) -> bool:
    """Whether every output of ``func`` aliases an input that it does not
    write (a view or bookkeeping op whose schema says so)."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _counters() -> List[OpCounter]:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCounter)]


class charge:
    """``with charge(name, work):`` adds ``work()`` (a ``kernel_work.Work``,
    evaluated only when a counter is active, with counting suspended)
    to every active counter under ``name`` and suspends the counting of
    the ops inside the block: a hand-written kernel's wrapper charges its
    function's work once, however its kernel or plain version runs."""

    def __init__(self, name: str, work: Callable[[], Work]):
        self.name, self.work = name, work
        self.counters: List[OpCounter] = []

    def __enter__(self):
        self.counters = _counters() if _ACTIVE else []
        for c in self.counters:
            c._suspended += 1
        if self.counters:
            w = self.work()
            for c in self.counters:
                c._add(self.name, w.ops, w.bytes)
        return self

    def __exit__(self, *exc):
        for c in self.counters:
            c._suspended -= 1


def charged(work_of: Callable[[dict], Work]):
    """``charge`` as a decorator of a kernel wrapper: each call charges,
    under the wrapper's name, ``work_of`` of its arguments by name (the
    defaults filled in)."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)

            def work():
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                return work_of(bound.arguments)
            with charge(fn.__name__, work):
                return fn(*args, **kwargs)
        return call
    return wrap


def _storage_bytes(tree) -> int:
    seen: Dict[int, int] = {}
    for t in _tensors(tree):
        s = _local(t).untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def analyze(fn: Callable, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter`` and return its
    ``Cost`` (the result is dropped: on ``meta`` it is no result, only a
    count).  Tensors in the arguments are the program's arguments; on
    CUDA tensors the temp size is the card's peak allocation above what
    was allocated at the start."""
    cuda = [t.device for t in _tensors((args, kwargs))
            if t.device.type == "cuda"]
    if cuda:
        torch.cuda.synchronize(cuda[0])
        torch.cuda.reset_peak_memory_stats(cuda[0])
        base = torch.cuda.memory_allocated(cuda[0])
    counter = OpCounter()
    t0 = time.perf_counter()
    with counter:
        out = fn(*args, **kwargs)
    cost = counter.cost
    cost.seconds = time.perf_counter() - t0
    cost.argument_bytes = _storage_bytes((args, kwargs))
    cost.output_bytes = _storage_bytes(out)
    cost.temp_bytes = counter._peak
    if cuda:
        torch.cuda.synchronize(cuda[0])
        cost.temp_bytes = torch.cuda.max_memory_allocated(cuda[0]) - base
    return cost
