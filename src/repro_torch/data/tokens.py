"""Deterministic synthetic LM data (the port's copy of the numpy-only
``repro/data/tokens.py``; bit-identical batches, held so in
``tests/test_torch_data.py``).

No external corpora exist offline, so the pipeline synthesizes a Zipfian
token stream with planted n-gram structure (so a real model can reduce
loss below the unigram entropy). The iterator is stateless-resumable:
batch ``i`` is a pure function of (seed, i), which is what makes
checkpoint-resume exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram: int = 3          # planted structure order
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # unigram zipf over a shuffled alphabet
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        probs /= probs.sum()
        self._unigram = probs[rng.permutation(v)]
        # deterministic bigram successor table: token t -> preferred next
        self._succ = rng.integers(0, v, size=v, dtype=np.int64)

    def batch(self, index: int) -> dict:
        """Batch ``index`` as {tokens, labels} int32 (B, S)."""
        rng = np.random.default_rng((self.seed, index))
        B, S, v = self.global_batch, self.seq_len, self.vocab_size
        base = rng.choice(v, size=(B, S + 1), p=self._unigram)
        # plant structure: with prob .5 a token is succ(prev) — learnable
        follow = rng.random((B, S)) < 0.5
        seq = base.copy()
        for t in range(1, S + 1):
            seq[:, t] = np.where(follow[:, t - 1],
                                 self._succ[seq[:, t - 1]], base[:, t])
        return {
            "tokens": seq[:, :S].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def token_batches(vocab_size: int, seq_len: int, global_batch: int,
                  seed: int = 0, start: int = 0) -> Iterator[dict]:
    ds = SyntheticLMDataset(vocab_size, seq_len, global_batch, seed)
    i = start
    while True:
        yield ds.batch(i)
        i += 1
