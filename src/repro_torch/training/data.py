"""Synthetic data pipeline: Zipf-distributed token streams with structure.

Real text has Zipf-distributed unigrams (the property SHVS exploits); we
synthesize sequences with (a) Zipf unigram marginals and (b) a short-range
Markov flavour (repeated n-grams) so that penalties/repetition paths see
realistic inputs and the model has something learnable. Batches are produced
ahead of time on a background thread (prefetch) to mimic a real input
pipeline.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    zipf_s: float = 1.1
    repeat_prob: float = 0.2      # chance of copying a recent token
    seed: int = 0


class SyntheticDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_s)
        self.probs = p / p.sum()

    def sample_batch(self) -> dict:
        c = self.cfg
        base = self._rng.choice(c.vocab_size, size=(c.batch_size, c.seq_len + 1),
                                p=self.probs).astype(np.int32)
        # short-range repetition structure
        rep = self._rng.random((c.batch_size, c.seq_len + 1)) < c.repeat_prob
        lag = self._rng.integers(1, 8, size=(c.batch_size, c.seq_len + 1))
        idx = np.maximum(np.arange(c.seq_len + 1)[None, :] - lag, 0)
        rows = np.arange(c.batch_size)[:, None]
        toks = np.where(rep, base[rows, idx], base)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.sample_batch()


class PrefetchLoader:
    """Background-thread prefetch (depth-N) over a dataset iterator."""

    def __init__(self, dataset: SyntheticDataset, depth: int = 2):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        it = iter(self.dataset)
        while not self._stop.is_set():
            try:
                self.q.put(next(it), timeout=0.1)
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
