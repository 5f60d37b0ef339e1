"""Synthetic LM data pipeline, after ``repro.data.pipeline``: seeded token
streams and document packing (numpy, copied so that the batches are
bit-identical to the reference's), and the host-to-device copy of a
batch.

A mesh (the reference's sharding of the batch over the data axes) has no
counterpart on one card: ``shard_batch`` raises for one (ROADMAP A8.4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.engine import resolve_device


@dataclass
class SyntheticSource:
    """Zipf-distributed token 'documents' with EOS separators — enough
    structure for a LM loss to fall measurably in a few hundred steps."""
    vocab_size: int
    seed: int = 0
    mean_doc_len: int = 64
    zipf_a: float = 1.3

    def documents(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        top = max(self.vocab_size - 2, 2)
        while True:
            n = max(4, int(rng.exponential(self.mean_doc_len)))
            toks = rng.zipf(self.zipf_a, size=n) % top + 1
            # inject n-gram structure: repeat a motif so the model has
            # something learnable
            if n >= 12:
                motif = toks[:4]
                toks[4:8] = motif
            yield toks.astype(np.int32)


class PackedBatcher:
    """Greedy document packing into fixed (batch, seq) windows with EOS=0
    separators; targets are next-token shifted."""

    def __init__(self, source: SyntheticSource, batch: int, seq: int):
        self.source = source
        self.batch = batch
        self.seq = seq
        self._docs = source.documents()
        self._buf = np.zeros(0, np.int32)

    def _fill(self, n: int) -> np.ndarray:
        while len(self._buf) < n:
            d = next(self._docs)
            self._buf = np.concatenate([self._buf, d, [0]])
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        need = self.batch * (self.seq + 1)
        flat = self._fill(need).reshape(self.batch, self.seq + 1)
        return {"tokens": flat[:, :-1].copy(),
                "targets": flat[:, 1:].copy()}


def shard_batch(batch: Dict[str, np.ndarray], mesh=None, *, device=None
                ) -> Dict[str, torch.Tensor]:
    """One host-to-device copy of each array of a host batch; ``device``
    None is the CUDA card, ``"cpu"`` the host."""
    if mesh is not None:
        raise NotImplementedError("shard_batch: a mesh needs more than one "
                                  "device (ROADMAP A8.4)")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def make_pipeline(vocab_size: int, batch: int, seq: int, *, seed: int = 0
                  ) -> PackedBatcher:
    return PackedBatcher(SyntheticSource(vocab_size, seed=seed), batch, seq)
