"""Synthetic-but-structured data pipeline.

Deterministic PRNG token streams with Zipfian unigram statistics and induced
bigram structure, packed into fixed-length training batches. Gives training
runs a learnable signal (loss drops well below uniform entropy) without any
external datasets — this container is offline.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Zipf unigrams + deterministic bigram successor structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # each token has a preferred successor; followed with prob 0.5
        self.successor = rng.permutation(v)
        self._rng = np.random.default_rng(cfg.seed + 1)

    def _sample_seq(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        out[0] = self._rng.choice(self.cfg.vocab_size, p=self.unigram)
        follow = self._rng.uniform(size=n) < 0.5
        fresh = self._rng.choice(self.cfg.vocab_size, p=self.unigram, size=n)
        for i in range(1, n):
            out[i] = self.successor[out[i - 1]] if follow[i] else fresh[i]
        return out

    def batches(self) -> Iterator[dict]:
        c = self.cfg
        while True:
            toks = np.stack([self._sample_seq(c.seq_len + 1)
                             for _ in range(c.batch_size)])
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}
