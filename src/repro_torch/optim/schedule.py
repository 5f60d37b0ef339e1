"""LR schedules (callable step -> multiplier), after
``repro.optim.schedule``: a function of an int or 0-d tensor step,
computed in float32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def cosine_with_warmup(warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1):
    def f(step) -> torch.Tensor:
        step = _f32(step)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * prog))
        return warm * cos
    return f


def constant():
    return lambda step: torch.ones((), dtype=torch.float32)
