"""Deterministic synthetic token pipeline for the training examples/dry-runs.

Generates Zipf-distributed token streams with document structure (BOS-delimited
segments) — enough statistical structure for a language-modeling loss to fall
during the example run, with zero external data dependencies.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticTokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int, *,
                 seed: int = 0, zipf_a: float = 1.3, mean_doc_len: int = 512):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        self.mean_doc_len = mean_doc_len
        # fixed bigram mixing table gives learnable sequential structure
        self._shift = self.rng.integers(1, vocab_size, size=1024)

    def _stream(self, n: int) -> np.ndarray:
        z = self.rng.zipf(self.zipf_a, size=n)
        toks = np.minimum(z, self.vocab_size - 2).astype(np.int64)
        # inject learnable bigram structure: every 2nd token derived from prev
        prev = np.roll(toks, 1)
        mask = (np.arange(n) % 2).astype(bool)
        derived = (prev + self._shift[prev % 1024]) % (self.vocab_size - 2)
        toks = np.where(mask, derived, toks)
        # BOS-delimited "documents"
        doc_breaks = self.rng.random(n) < (1.0 / self.mean_doc_len)
        toks[doc_breaks] = self.vocab_size - 1
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            n = self.batch_size * self.seq_len
            yield {"tokens": self._stream(n).reshape(
                self.batch_size, self.seq_len).astype(np.int32)}
