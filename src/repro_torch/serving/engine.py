"""Serving engine, after ``repro.serving.engine``: batched greedy decode
with a Morpheus two-tier prefix-page cache.

Prompt KV is chunked into pages keyed by (prefix hash, layer, page);
requests that share a prefix hit its cached pages.  The two-tier pool
(``paged_kv.MorpheusPagePool``, on the engine's device) decides where
pages live and accounts for the hits with the reference's modeled tier
costs.  As in the reference, the pool only accounts: ``run`` runs the
full prefill whatever the pool says.

The structure is the reference's: one ``lookup_batch`` per page key, a
payload digest installed by ``write_page`` on a backing fetch, then the
model's prefill and a greedy decode loop that reads the next tokens back
to the host once a step (on the CPU an MoE model's decode step adds one
read-back a MoE layer, its experts' segment lengths; on a card its
experts run as grouped kernels with none: ``models.moe``).  With tracing
on (``obs.enable()``) a batch is a ``serve.batch`` span holding
``serve.consult`` (the page keys' pool calls), ``serve.prefill`` and one
``serve.decode_step`` an iteration of the loop, whose ``serve.readback``
is the read of the tokens (docs/observability.md).
``Engine(model, params)`` runs on the model's device: the CUDA card
unless the model was built with ``device="cpu"``.
With the cache-content inspector on (``obs.enable(inspect=True)``) each
consulted page key is noted with its request's tenant, as in the
reference, so ``MorpheusPagePool.content_snapshot`` can attribute
resident pages.  An encoder-decoder model's prefill reads zero audio
frames (B, 8, d_model) from the stubbed frontend, as the reference's
``run`` gives it, and keeps the encoder's output in the caches for decode.
(The reference also encodes those frames once before the prefill and
stores the result in the caches, where the prefill's own encoding of the
same frames replaces it; the port encodes once.)
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .. import obs
from ..models.transformer import LM
from ..models.weights import params_from_numpy
from . import sampler as S
from .paged_kv import MorpheusPagePool, PoolConfig, page_key

PAGE_TOKENS = 16


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    tenant: str = ""     # owning tenant label (residency audit only)


def _prefix_hash(tokens: List[int]) -> int:
    h = hashlib.blake2b(np.asarray(tokens, np.int32).tobytes(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little")


def page_payload(prefix: List[int]) -> np.ndarray:
    """A fetched page's 128-byte payload: two salted 64-byte blake2b
    digests of the prefix's ``repr`` (blake2b caps digest_size at 64)."""
    raw = bytes(prefix.__repr__(), "utf8")
    digest = (hashlib.blake2b(raw, digest_size=64, salt=b"pg0").digest()
              + hashlib.blake2b(raw, digest_size=64, salt=b"pg1").digest())
    return np.frombuffer(digest, dtype=np.uint32).copy()


@dataclass
class EngineReport:
    steps: int
    generated: int
    page_hit_rate: float
    pages_reused: int
    pages_fetched: int
    modeled_time_ns: float
    pred_miss: int
    false_pos: int


class Engine:
    """Greedy continuous-batching-lite engine with Morpheus page cache.

    ``params`` None serves the model's own weights; a reference parameter
    tree (numpy arrays) is loaded into the model first
    (``weights.params_from_numpy``)."""

    def __init__(self, model: LM, params=None, *, max_len: int = 256,
                 pool: Optional[MorpheusPagePool] = None,
                 morpheus: bool = True):
        if params is not None:
            params_from_numpy(model, params)
        self.model = model
        self.max_len = max_len
        self.morpheus = morpheus
        self.pool = pool or MorpheusPagePool(PoolConfig(
            num_cache_chips=4 if morpheus else 0,
            conv_sets=64, ext_sets_per_chip=32, ways=4), device=model.device)
        self.pages_reused = 0
        self.pages_fetched = 0
        self.batches = 0

    # ------------------------------------------------------------- serving
    def run(self, requests: List[Request]) -> EngineReport:
        """Serve a batch of requests to completion (equal lengths batch)."""
        b = len(requests)
        plen = len(requests[0].prompt)
        assert all(len(r.prompt) == plen for r in requests), \
            "demo engine batches equal-length prompts"
        self.batches += 1
        with obs.span("serve.batch", batch=self.batches,
                      rids=[r.rid for r in requests], b=b,
                      prompt_tokens=plen):
            steps = self._serve(requests, plen)
        st = self.pool.stats
        return EngineReport(
            steps=steps,
            generated=sum(len(r.out_tokens) for r in requests),
            page_hit_rate=self.pool.hit_rate(),
            pages_reused=self.pages_reused,
            pages_fetched=self.pages_fetched,
            modeled_time_ns=st.time_ns,
            pred_miss=st.ext_pred_miss,
            false_pos=st.ext_false_pos,
        )

    def _serve(self, requests: List[Request], plen: int) -> int:
        """The batch's pool consultation, prefill and decode loop; returns
        the decode steps run."""
        b = len(requests)
        # ---- page-cache consultation for prompt KV (prefix caching)
        n_pages = plen // PAGE_TOKENS
        ins = obs.inspector()
        with obs.span("serve.consult", keys=len(requests) * n_pages):
            for r in requests:
                for pg in range(n_pages):
                    prefix = r.prompt[: (pg + 1) * PAGE_TOKENS]
                    key = page_key(_prefix_hash(prefix), 0, pg)
                    if ins is not None and r.tenant:
                        # page keys carry no tenant bits; note ownership
                        # at consult time so the pool's residency decode
                        # can attribute resident pages back to tenants
                        ins.note_owner(key, r.tenant)
                    plan = self.pool.lookup_batch(
                        np.asarray([key], np.uint32))
                    if plan.tier[0] == 2:
                        self.pages_fetched += 1   # backing fetch = recompute
                        self.pool.write_page(key, page_payload(prefix))
                    else:
                        self.pages_reused += 1

        # ---- real prefill + decode
        model = self.model
        tokens = torch.tensor([r.prompt for r in requests],
                              dtype=torch.int32, device=model.device)
        caches = model.init_caches(b, self.max_len)
        batch = {"tokens": tokens}
        if model.cfg.is_encdec:
            batch["frame_embeds"] = torch.zeros(
                (b, 8, model.cfg.d_model), dtype=torch.float32,
                device=model.device)
        with obs.span("serve.prefill"):
            logits, caches = model.prefill(batch, caches)
        steps = 0
        cur = S.greedy(logits)
        max_new = max(r.max_new_tokens for r in requests)
        for t in range(max_new):
            with obs.span("serve.decode_step", t=t):
                # the engine's one host read a step (an MoE model's step
                # adds one a MoE layer)
                with obs.span("serve.readback",
                              bytes=cur.numel() * cur.element_size()):
                    host = cur.tolist()
                for i, r in enumerate(requests):
                    if not r.done:
                        r.out_tokens.append(int(host[i]))
                        r.done = len(r.out_tokens) >= r.max_new_tokens
                if all(r.done for r in requests):
                    break
                logits, caches = model.decode_step(cur, caches, plen + t)
                cur = S.greedy(logits)
                steps += 1
        return steps
