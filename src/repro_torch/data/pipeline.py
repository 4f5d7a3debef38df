"""Deterministic synthetic token pipeline (prefetching), the counterpart of
``repro.data.pipeline``.

Every batch is a pure function of (seed, step): no iterator state to
checkpoint, so a restored run replays the same batches.  The stream is a
mixture of structured sequences (repeated n-grams, arithmetic progressions,
noisy copies) rather than iid noise, so small models show a real,
decreasing loss.

:func:`synth_tokens` is the reference's, numpy for numpy, so the tokens are
the reference's bytes for every ``(seed, step)``.  The stub-frontend
``embeds`` are ``default_rng(step).standard_normal`` in float32 rounded to
bfloat16 to nearest even (PyTorch's cast on the CPU, which is what
``ml_dtypes`` does for the reference).  The reference's ``sharding``
argument (a global batch assembled per host shard) has no counterpart on
one device; batches are made on the host and moved to ``device``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .. import resolve_device

__all__ = ["TokenPipeline", "synth_tokens"]


def synth_tokens(seed: int, step: int, batch: int, seq_len: int, vocab: int) -> np.ndarray:
    """(batch, seq_len) int32 — deterministic, structured."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
    out = np.empty((batch, seq_len), np.int32)
    for i in range(batch):
        kind = rng.integers(0, 3)
        if kind == 0:  # repeated n-gram
            n = int(rng.integers(2, 9))
            gram = rng.integers(0, vocab, n)
            reps = -(-seq_len // n)
            out[i] = np.tile(gram, reps)[:seq_len]
        elif kind == 1:  # arithmetic progression mod vocab
            a, d = rng.integers(0, vocab), int(rng.integers(1, 17))
            out[i] = (a + d * np.arange(seq_len)) % vocab
        else:  # noisy copy: first half random, second half copies
            half = seq_len // 2
            first = rng.integers(0, vocab, half)
            out[i, :half] = first
            out[i, half:] = np.resize(first, seq_len - half)
    return out


class TokenPipeline:
    """Prefetching host data pipeline; batches land on ``device`` (None:
    the card)."""

    def __init__(
        self,
        batch: int,
        seq_len: int,
        vocab: int,
        seed: int = 0,
        prefetch: int = 2,
        embeds_dim: int = 0,  # >0: emit precomputed-embedding stub inputs
        device=None,
    ):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab
        self.seed = seed
        self.embeds_dim = embeds_dim
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = 0
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _make(self, step: int) -> dict:
        toks = torch.from_numpy(
            synth_tokens(self.seed, step, self.batch, self.seq_len, self.vocab))
        batch = {"labels": toks}
        if self.embeds_dim:
            rng = np.random.default_rng(step)
            embeds = rng.standard_normal(
                (self.batch, self.seq_len, self.embeds_dim), np.float32)
            batch["embeds"] = torch.from_numpy(embeds).to(torch.bfloat16)
        else:
            batch["tokens"] = toks
        return {k: v.to(self.device) for k, v in batch.items()}

    def batch_at(self, step: int) -> dict:
        """Pure access — used for resume and tests."""
        return self._make(step)

    def __iter__(self) -> Iterator[dict]:
        def worker():
            s = self._step
            while not self._stop.is_set():
                try:
                    self._q.put(self._make(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        self._worker = threading.Thread(target=worker, daemon=True)
        self._worker.start()
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
