"""Arithmetic the metric readers share: the counted work of a run's
rounds and steps (``work/``) set against its host spans and its device
trace.  Every function returns None where the run holds nothing to read:
no span, no trace, no kernel of that name."""
from __future__ import annotations

from statistics import median
from typing import Optional

from work import flops, hw, kernels
from .trace import device_seconds, launches


def is_flash(name: str) -> bool:
    return "flash_kernel" in name


def is_decode(name: str) -> bool:
    return "decode_partial_kernel" in name or "decode_combine_kernel" in name


def is_flash_bwd(name: str) -> bool:
    return "bwd_dq" in name or "bwd_dkdv" in name


def span_s(rec: dict, *names: str) -> Optional[float]:
    got = [rec["spans"][n][0] for n in names if n in rec["spans"]]
    return sum(got) if got else None


def span_ms_per_call(rec: dict, name: str) -> Optional[float]:
    if name not in rec["spans"] or not rec["spans"][name][1]:
        return None
    total, calls = rec["spans"][name]
    return 1e3 * total / calls


def ms_per_round(rec: dict, *names: str) -> Optional[float]:
    t = span_s(rec, *names)
    if t is None or not rec["round_shapes"]:
        return None
    return 1e3 * t / len(rec["round_shapes"])


def _attn(cfg: dict) -> tuple:
    return cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]


def prefill_mfu(rec: dict) -> Optional[float]:
    t = span_s(rec, "prefill")
    if not t:
        return None
    cfg, s = rec["config"], rec["mix"]["prompt_tokens"]
    work = sum(flops.prefill_flops(cfg, b, s) for b, _, _ in
               rec["round_shapes"])
    return 100 * work / (t * hw.PEAK_FLOPS_F32)


def round_flops(cfg: dict, s: int, b: int, steps: int) -> float:
    return flops.prefill_flops(cfg, b, s) + sum(
        flops.decode_flops(cfg, b, s + t) for t in range(steps))


def round_mfu(rec: dict) -> Optional[float]:
    shapes = rec["round_shapes"]
    if not shapes:
        return None
    cfg, s = rec["config"], rec["mix"]["prompt_tokens"]
    work = sum(round_flops(cfg, s, b, n) for b, n, _ in shapes)
    return 100 * work / (sum(w for _, _, w in shapes) * hw.PEAK_FLOPS_F32)


def serve_flash_roofline(rec: dict) -> Optional[float]:
    t = device_seconds(rec["trace"], is_flash)
    if t is None:
        return None
    cfg, s = rec["config"], rec["mix"]["prompt_tokens"]
    h, kvh, hd = _attn(cfg)
    bound = sum(cfg["num_layers"] * hw.bound_s(*kernels.flash_work(
        b, s, s, h, kvh, hd, hd)) for b, _ in rec["trace"]["rounds"])
    return 100 * bound / t


def serve_decode_roofline(rec: dict) -> Optional[float]:
    t = device_seconds(rec["trace"], is_decode)
    if t is None:
        return None
    cfg, mix = rec["config"], rec["mix"]
    s, cache = mix["prompt_tokens"], mix["prompt_tokens"] + mix["new_tokens"]
    h, kvh, hd = _attn(cfg)
    bound = sum(cfg["num_layers"] * hw.bound_s(*kernels.decode_work(
        b, h, kvh, hd, cache, b * (s + k + 1)))
        for b, steps in rec["trace"]["rounds"] for k in range(steps))
    return 100 * bound / t


def idle_share(rec: dict) -> Optional[float]:
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])


def pool_hit_rate(rec: dict) -> Optional[float]:
    reused, fetched = rec["pages"]
    if reused + fetched == 0:
        return None
    return 100 * reused / (reused + fetched)


def queue_wait_ms(rec: dict) -> Optional[float]:
    w = rec["queue_wait_s"]
    return 1e3 * median(w) if w else None


def train_mfu(rec: dict) -> Optional[float]:
    if not rec["steps"]:
        return None
    mix = rec["mix"]
    work = rec["steps"] * flops.train_flops(rec["config"], mix["batch"],
                                            mix["seq"])
    return 100 * work / (rec["elapsed_s"] * hw.PEAK_FLOPS_F32)


def _train_shape(rec: dict) -> tuple:
    cfg, mix = rec["config"], rec["mix"]
    h, kvh, hd = _attn(cfg)
    return (mix["batch"], mix["seq"], mix["seq"], h, kvh, hd, hd)


def train_flash_roofline(rec: dict) -> Optional[float]:
    """Every forward launch of the traced steps (recomputation included)
    against one layer's forward work each."""
    t = device_seconds(rec["trace"], is_flash)
    if t is None:
        return None
    n = launches(rec["trace"], is_flash)
    return 100 * n * hw.bound_s(*kernels.flash_work(*_train_shape(rec))) / t


def train_flash_bwd_roofline(rec: dict) -> Optional[float]:
    """One backward a layer and traced step."""
    t = device_seconds(rec["trace"], is_flash_bwd)
    if t is None:
        return None
    calls = rec["config"]["num_layers"] * rec["trace"]["steps"]
    return 100 * calls * hw.bound_s(
        *kernels.flash_backward_work(*_train_shape(rec))) / t
