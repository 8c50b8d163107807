"""Deterministic synthetic LM data (a copy of ``repro.data.synthetic``, in
numpy): a mixture of Zipfian unigrams and copy/induction patterns so small
models have learnable structure. ``batch(step, n)`` is a pure function of
(seed, step, n), bit-identical to the reference's."""
from __future__ import annotations

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 copy_period: int = 16):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.copy_period = copy_period
        probs = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
        self._probs = probs / probs.sum()

    def batch(self, step: int, batch_size: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        toks = rng.choice(self.vocab_size, size=(batch_size, self.seq_len),
                          p=self._probs).astype(np.int32)
        # induction structure: second half repeats the first half shifted
        half = self.seq_len // 2
        period = min(self.copy_period, half)
        toks[:, half:half + period] = toks[:, :period]
        return toks
