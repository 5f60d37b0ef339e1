"""The one traffic generator: every mix is a JSON file of parameters
under ``mixes/``, read here.

A serving mix draws requests of one prompt length: ``shared_prefix``
(optional) gives each prompt one of ``count`` system prompts of
``tokens`` tokens, Zipf(``zipf_s``)-popular, before a part unique to the
request; ``arrival`` offers them open-loop at ``rate_per_s``, after a
``backlog`` already queued at the start.  The gaps between arrivals
are the quantiles of the exponential distribution in one order, the
same for every seed: a served batch's composition, and so the time to
first token, depends on every arrival before it, and runs that differ
in the schedule spread far more than runs of one schedule.  What the
seed changes is the data: which tokens, and which system prompt a
request gets (every seed has the same number of requests of each), so
that seeds vary the data and not the amount of work.

A training mix draws batches of ``batch`` rows of ``seq`` random tokens
(the targets are the tokens shifted by one), with equal M-RoPE streams
as positions when ``mrope_positions`` is set.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .weights import sub_seed


class Request(NamedTuple):
    rid: int
    prompt: np.ndarray      # int64 tokens
    arrival: float          # seconds after the window opens
    system: int             # its system prompt, or -1


def _rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def _zipf_counts(n: int, count: int, s: float) -> np.ndarray:
    """Requests of each of ``count`` Zipf(s)-popular system prompts among
    ``n``, by largest remainder (the same for every seed)."""
    p = 1.0 / np.arange(1, count + 1) ** s
    want = n * p / p.sum()
    got = np.floor(want).astype(np.int64)
    got[np.argsort(-(want - got), kind="stable")[:n - got.sum()]] += 1
    return got


def serve_requests(mix: dict, vocab: int, seed: int, seconds: float,
                   tag: str = "window") -> List[Request]:
    """The backlog and the requests that arrive in a window of
    ``seconds``, in arrival order."""
    arr = mix["arrival"]
    n_stream = max(1, round(arr["rate_per_s"] * seconds))
    n = arr.get("backlog", 0) + n_stream
    q = (np.arange(n_stream) + 0.5) / n_stream
    gaps = -np.log1p(-q) / arr["rate_per_s"]
    gaps = _rng(0, tag + ":gaps").permutation(gaps)
    gaps *= seconds / gaps.sum()
    times = np.concatenate([np.zeros(arr.get("backlog", 0)),
                            np.cumsum(gaps) - gaps])
    return _prompts(mix, vocab, seed, tag, times)


def warmup_requests(mix: dict, vocab: int, seed: int, n: int
                    ) -> List[Request]:
    """``n`` requests of the mix for the warm-up, drawn apart from the
    window's but with the same system prompts."""
    return _prompts(mix, vocab, seed, "warmup", np.zeros(n))


def _prompts(mix: dict, vocab: int, seed: int, tag: str,
             times: np.ndarray) -> List[Request]:
    n, plen = len(times), mix["prompt_tokens"]
    rng = _rng(seed, tag + ":tokens")
    sp = mix.get("shared_prefix")
    if sp:
        sys_tokens = _rng(seed, "system").integers(
            0, vocab, (sp["count"], sp["tokens"]))
        which = np.repeat(np.arange(sp["count"]),
                          _zipf_counts(n, sp["count"], sp["zipf_s"]))
        which = _rng(seed, tag + ":system").permutation(which)
        own = rng.integers(0, vocab, (n, plen - sp["tokens"]))
        prompts = [np.concatenate([sys_tokens[w], o])
                   for w, o in zip(which, own)]
    else:
        which = np.full(n, -1)
        prompts = list(rng.integers(0, vocab, (n, plen)))
    return [Request(i, p.astype(np.int64), float(t), int(w))
            for i, (p, t, w) in enumerate(zip(prompts, times, which))]


def train_batch(mix: dict, vocab: int, seed: int, step: int,
                device) -> Dict[str, torch.Tensor]:
    """Batch ``step`` of a training mix, drawn on ``device``."""
    b, s = mix["batch"], mix["seq"]
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, f"batch{step}"))
    toks = torch.randint(0, vocab, (b, s + 1), generator=gen, device=device)
    out = {"tokens": toks[:, :-1].contiguous(),
           "targets": toks[:, 1:].contiguous()}
    if mix.get("mrope_positions"):
        out["positions"] = torch.arange(s, device=device).expand(3, b, s)
    return out
