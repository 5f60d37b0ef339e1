"""Token samplers for the decode loop, after ``repro.serving.sampler``.

``sample`` draws from an explicit ``torch.Generator``; it cannot give the
bits of ``jax.random``, so only its support and distribution match the
reference's.  The engine uses ``greedy``."""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the largest logit (the first on ties), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(generator: Optional[torch.Generator], logits: torch.Tensor, *,
           temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """One token per row of ``logits`` (..., V): greedy at temperature
    <= 0, else from softmax(logits / temperature), restricted to the
    ``top_k`` largest logits (ties with the k-th kept) when ``top_k``."""
    logits = logits.float()
    if temperature <= 0:
        return greedy(logits)
    logits = logits / temperature
    if top_k:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)
