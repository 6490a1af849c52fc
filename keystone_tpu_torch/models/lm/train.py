"""LM training — the part of ``keystone_tpu/models/lm/train.py`` that the
scoring path needs: the synthetic corpus (numpy, copied as it is). The
optimizers, train steps and loop come with the training slice."""

from __future__ import annotations

import numpy as np


def synthetic_corpus(n: int, vocab: int, seed: int = 0) -> np.ndarray:
    """A learnable-but-not-trivial token stream: an order-1 Markov chain
    with a sparse, deterministic-ish transition structure."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, 4))
    probs = np.array([0.7, 0.15, 0.1, 0.05])
    out = np.empty(n, np.int32)
    out[0] = 0
    choices = rng.choice(4, size=n, p=probs)
    for i in range(1, n):
        out[i] = succ[out[i - 1], choices[i]]
    return out
