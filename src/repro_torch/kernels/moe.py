"""The MoE layer's routed experts for a decode-sized call:
``grouped_experts``, the hand-written CUDA kernels of ``csrc/moe.cu``,
and its plain PyTorch version.

It replaces no Pallas kernel: the reference runs its experts as einsums
over an (E, capacity, D) buffer (``src/repro/models/moe.py``,
``_moe_mlp_dense``).  The port's segment loop (``models.moe._experts``)
reads the experts' segment lengths back to the host and launches about
eight kernels an expert hit; on a decode step that host work, not the
card, sets the pace.  ``grouped_experts`` computes the same function
from the routing as it lies on the device, in two launches and with no
read-back: ``grouped_gate_up_kernel`` (a block an (expert, 64 columns of
F) that lists its expert's pairs from the routing, stages their input
rows in shared memory and streams ``w_gate[e]`` and ``w_up[e]`` once,
writing ``act(x Wg) * (x Wu)`` a pair) and ``grouped_down_kernel`` (the
same over ``w_down[e]``, a row of D a pair; dropped pairs get zero rows).
Bound by device-memory bytes: each expert hit is read once where it lies,
f32 sums on the CUDA cores.  The combine is PyTorch: each pair's row
scaled by ``weight * keep`` and the k slots summed in slot order, as
``_experts``' last two lines, so the result does not depend on
scheduling.

bf16 rounds where the segment loop's cuBLAS calls round: x Wg, x Wu, the
activation, their product and h Wd each to bf16, sums in f32.

The kernels take at most ``MAX_TOKENS`` tokens (the rows an expert's
accumulators hold in registers) and ``MAX_PAIRS`` (token, slot) pairs a
call, and even D and F.  On CUDA tensors ``grouped_experts`` launches
both kernels (and adds one to ``launches["grouped_experts"]``) or
raises; on CPU tensors it runs its plain version (and adds one to
``plain_runs``).  An active op counter (``roofline.op_cost``) is charged
``kernel_work.grouped_experts_work``, whichever runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from . import _build
from ..roofline import kernel_work, op_cost

MAX_TOKENS = 32
MAX_PAIRS = 512
WRAPPERS = ("grouped_experts",)
ACTS = {"silu": 0, "gelu": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel pair since the last ``reset_launches``, and runs
# of the plain version (which never count as launches).
launches: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)
plain_runs: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)


def reset_launches() -> None:
    for k in WRAPPERS:
        launches[k] = plain_runs[k] = 0


def fits(tokens: int, top_k: int, dtype: torch.dtype, d: int,
         f: int) -> bool:
    """Whether the kernels take a call of ``tokens`` tokens routed to
    ``top_k`` experts each, of ``dtype``, D = ``d`` and F = ``f``."""
    return (1 <= tokens <= MAX_TOKENS and 1 <= tokens * top_k <= MAX_PAIRS
            and dtype in _DTYPES and d % 2 == 0 and f % 2 == 0)


def _check(x2, expert, weight, keep, w_gate, w_up, w_down, act) -> None:
    if x2.dim() != 2:
        raise ValueError(f"x2 must be (T, D), got {tuple(x2.shape)}")
    t, d = x2.shape
    if w_gate.dim() != 3:
        raise ValueError(f"w_gate must be (E, D, F), got "
                         f"{tuple(w_gate.shape)}")
    e, f = w_gate.shape[0], w_gate.shape[2]
    if t < 1 or expert.dim() != 1 or expert.numel() % t:
        raise ValueError(f"{t} tokens and {tuple(expert.shape)} experts: "
                         "expected T >= 1 and T * k expert ids")
    if not fits(t, expert.numel() // t, x2.dtype, d, f):
        raise ValueError(f"T {t}, k {expert.numel() // t}, {x2.dtype}, D "
                         f"{d}, F {f}: the kernels take 1 <= T <= "
                         f"{MAX_TOKENS}, T * k <= {MAX_PAIRS}, float32 or "
                         "bfloat16, even D and F")
    if act not in ACTS:
        raise ValueError(f"act {act!r}, expected one of {tuple(ACTS)}")
    dev, p = x2.device, expert.numel()
    _build.check("x2", x2, x2.dtype, (t, d), dev)
    _build.check("expert", expert, torch.int64, (p,), dev)
    _build.check("weight", weight, torch.float32, (p,), dev)
    _build.check("keep", keep, torch.bool, (p,), dev)
    _build.check("w_gate", w_gate, x2.dtype, (e, d, f), dev)
    _build.check("w_up", w_up, x2.dtype, (e, d, f), dev)
    _build.check("w_down", w_down, x2.dtype, (e, f, d), dev)


def grouped_experts_plain(x2: torch.Tensor, expert: torch.Tensor,
                          weight: torch.Tensor, keep: torch.Tensor,
                          w_gate: torch.Tensor, w_up: torch.Tensor,
                          w_down: torch.Tensor, act: str) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_experts``: each expert named by
    a kept pair runs its SwiGLU / GeGLU on its pairs' tokens, one pair a
    row; the rows scaled by their weights and summed over the k slots."""
    plain_runs["grouped_experts"] += 1
    t = x2.shape[0]
    k = expert.numel() // t
    y = torch.zeros((t * k, x2.shape[1]), dtype=x2.dtype, device=x2.device)
    for e in torch.unique(expert[keep]).tolist():
        rows = torch.nonzero(keep & (expert == e)).flatten()
        xe = x2[rows // k]
        a = xe @ w_gate[e]
        a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
        y[rows] = (a * (xe @ w_up[e])) @ w_down[e]
    y = y * (weight * keep).to(y.dtype)[:, None]
    return y.reshape(t, k, -1).sum(1)


@op_cost.charged(lambda a: kernel_work.grouped_experts_work(
    a["x2"], a["expert"], a["keep"], a["w_gate"]))
def grouped_experts(x2: torch.Tensor, expert: torch.Tensor,
                    weight: torch.Tensor, keep: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, act: str) -> torch.Tensor:
    """x2 (T, D); the routing of its T * k (token, slot) pairs, token-major:
    ``expert`` (int64), ``weight`` (f32) and ``keep`` (bool); the stacked
    experts ``w_gate``, ``w_up`` (E, D, F) and ``w_down`` (E, F, D) of
    x2's dtype; ``act`` ``"silu"`` or ``"gelu"`` (tanh) -> (T, D) in x2's
    dtype: the sum over the k slots of ``weight * keep`` times the pair's
    expert output (``models.moe._experts``' function)."""
    _check(x2, expert, weight, keep, w_gate, w_up, w_down, act)
    dev = x2.device
    if dev.type == "cpu":
        return grouped_experts_plain(x2, expert, weight, keep, w_gate, w_up,
                                     w_down, act)
    _build.require_cuda(dev, "grouped_experts")
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if w.data_ptr() % 16:
            raise ValueError(f"{name}: storage must start on 16 bytes")
    t, d = x2.shape
    e, f = w_gate.shape[0], w_gate.shape[2]
    p = expert.numel()
    h = torch.empty((p, f), dtype=x2.dtype, device=dev)
    y = torch.empty((p, d), dtype=x2.dtype, device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        err = _lib().grouped_experts_launch(
            ptr(x2), ptr(expert), ptr(keep), ptr(w_gate), ptr(w_up),
            ptr(w_down), ptr(h), ptr(y), _DTYPES[x2.dtype], ACTS[act], t,
            p // t, e, d, f, _build.stream(dev))
    _build.raise_on(err, "grouped_experts")
    launches["grouped_experts"] += 1
    y = y * (weight * keep).to(y.dtype)[:, None]
    return y.reshape(t, p // t, -1).sum(1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/moe.cu`` with its launcher declared; raises if its
    limits are not ``MAX_TOKENS`` and ``MAX_PAIRS``."""
    lib = _build.load("moe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_experts_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.grouped_experts_launch.restype = i
    for fn in (lib.grouped_max_tokens, lib.grouped_max_pairs):
        fn.argtypes = []
        fn.restype = i
    limits = (lib.grouped_max_tokens(), lib.grouped_max_pairs())
    if limits != (MAX_TOKENS, MAX_PAIRS):
        raise RuntimeError(f"moe.cu takes {limits} tokens and pairs, the "
                           f"wrapper {(MAX_TOKENS, MAX_PAIRS)}")
    return lib
