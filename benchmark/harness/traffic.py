"""The one generator of every traffic mix: rows, random draws, requests and
token batches, all from the run's seed and the mix's parameters
(``benchmark/traffic/<traffic>.json``).

Request lengths do not depend on the seed. A mix's lengths are one
stratum of ``stratum`` (prompt, output) pairs, taken at the quantiles of
the mix's distributions and paired by a fixed permutation; the seed
orders each stratum and draws the token ids. So every seed serves the
same lengths in another order, and any run that serves whole strata
serves the same work.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterator

import numpy as np
import torch


def _seed64(seed: int, stream: int) -> int:
    """A 64-bit seed for one of a run's streams (any whole-number seed)."""
    return int(np.random.SeedSequence([int(seed) & (2**63 - 1), stream]).generate_state(1, np.uint64)[0])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed64(seed, stream))


def mnist_rows(seed: int, rows: int, dim: int, classes: int, device) -> tuple:
    """MNIST-sized rows on the host: a N(0, 1) centre per class plus N(0, 1)
    noise per row, labels uniform; drawn on ``device`` in three calls."""
    g = device_generator(seed, 1, device)
    centres = torch.randn((classes, dim), generator=g, device=device)
    labels = torch.randint(0, classes, (rows,), generator=g, device=device)
    x = centres[labels] + torch.randn((rows, dim), generator=g, device=device)
    return x.cpu(), labels.cpu()


def fft_signs(seed: int, draws: int, dim: int) -> torch.Tensor:
    """(draws, dim) Rademacher signs, float32, on the host."""
    g = torch.Generator().manual_seed(_seed64(seed, 2))
    return (2 * torch.randint(0, 2, (draws, dim), generator=g) - 1).to(torch.float32)


def _quantile(dist: dict, q: float) -> int:
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "uniform":
        value = lo + q * (hi - lo)
    elif dist["dist"] == "lognormal":
        value = dist["median"] * math.exp(dist["sigma"] * statistics.NormalDist().inv_cdf(q))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return int(min(hi, max(lo, round(value))))


def stratum(params: dict) -> list[tuple[int, int]]:
    """The mix's (prompt, output) lengths: one stratum, seed-independent."""
    m = int(params["stratum"])
    prompts = [_quantile(params["prompt"], (i + 0.5) / m) for i in range(m)]
    outputs = [_quantile(params["output"], (i + 0.5) / m) for i in range(m)]
    pair = np.random.default_rng(0).permutation(m)
    return [(prompts[i], outputs[j]) for i, j in enumerate(pair)]


def requests(seed: int, params: dict, vocab: int) -> Iterator[tuple[np.ndarray, int]]:
    """An endless stream of (prompt token ids, output length)."""
    rng = np.random.default_rng(_seed64(seed, 3))
    base = stratum(params)
    while True:
        for i in rng.permutation(len(base)):
            p, o = base[i]
            yield rng.integers(0, vocab, size=p, dtype=np.int64), o


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int, device) -> torch.Tensor:
    """Step ``step``'s (batch, seq + 1) token ids, uniform over the
    vocabulary, drawn on ``device``."""
    g = device_generator(seed, 1000 + step, device)
    return torch.randint(0, vocab, (batch, seq + 1), generator=g, device=device)
