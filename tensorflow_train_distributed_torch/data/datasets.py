"""Synthetic dataset sources (the part of the JAX package's
``data/datasets.py`` the training slice needs, copied verbatim: it is
framework-free numpy).

Records are generated from a per-index PRNG: reproducible, O(1) storage,
and the same numbers as the JAX package's for the same seed and index.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, idx: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, idx]))


class SyntheticLM:
    """Causal-LM token streams from a learnable affine recurrence.

    ``t[i+1] = (a*t[i] + b) mod vocab`` with (a, b) drawn per sequence — a
    next-token structure a transformer learns quickly, for Llama SFT and
    decoder throughput/convergence runs.
    """

    def __init__(self, num_examples: int = 100_000, seq_len: int = 512,
                 vocab_size: int = 32_000, seed: int = 41):
        self.n, self.seq_len, self.vocab, self.seed = (
            num_examples, seq_len, vocab_size, seed)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = _rng(self.seed, idx)
        a = int(rng.integers(2, 64))
        b = int(rng.integers(0, self.vocab))
        t0 = int(rng.integers(0, self.vocab))
        toks = np.empty(self.seq_len + 1, np.int32)
        toks[0] = t0
        for i in range(self.seq_len):
            toks[i + 1] = (a * toks[i] + b) % self.vocab
        return {"tokens": toks[:-1], "targets": toks[1:]}


_REGISTRY = {"lm": SyntheticLM}


def get_dataset(name: str, **kwargs):
    if name not in _REGISTRY:
        raise ValueError(f"Unknown dataset {name!r}; available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
