"""Stupid Backoff n-gram language model — port of
``keystone_tpu/models/stupid_backoff_pipeline.py`` (the reference's
``StupidBackoffPipeline.scala``): tokenize → frequency-encode words →
n-grams up to ``max_order`` → counts → Stupid Backoff scores; the model
serves point queries.

Host code in both packages, copied: it uses no device. Run:
``python -m keystone_tpu_torch.models.stupid_backoff_pipeline
--synthetic 50000`` (or ``--train-location`` of a text file, directory or
glob).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time

import numpy as np

from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.ops.nlp import (
    NGramsCounts,
    NGramsFeaturizer,
    StupidBackoffEstimator,
    Tokenizer,
    WordFrequencyEncoder,
)

logger = get_logger("keystone_tpu_torch.models.stupid_backoff")


@dataclasses.dataclass
class StupidBackoffConfig:
    train_location: str = arg(default="", help="text file/dir/glob")
    max_order: int = arg(default=3)
    alpha: float = arg(default=0.4)
    synthetic: int = arg(default=0, help="if > 0, N synthetic sentences")


def _load_lines(conf: StupidBackoffConfig) -> list[str]:
    if conf.synthetic:
        rng = np.random.default_rng(0)
        vocab = ["the", "cat", "dog", "sat", "on", "mat", "ran", "fast", "a"]
        probs = np.asarray([0.25, 0.12, 0.12, 0.1, 0.1, 0.08, 0.08, 0.05, 0.1])
        return [
            " ".join(rng.choice(vocab, size=rng.integers(4, 12), p=probs))
            for _ in range(conf.synthetic)
        ]
    path = conf.train_location
    files = (
        sorted(glob.glob(os.path.join(path, "*")))
        if os.path.isdir(path)
        else sorted(glob.glob(path)) or [path]
    )
    lines: list[str] = []
    for f in files:
        with open(f, errors="replace") as fh:
            lines.extend(line for line in fh.read().splitlines() if line.strip())
    return lines


def run(conf: StupidBackoffConfig) -> tuple:
    """Count and fit; returns ``(result, model, encoder_model)``."""
    t0 = time.perf_counter()
    lines = _load_lines(conf)
    tokens = Tokenizer()(lines)

    encoder_model = WordFrequencyEncoder().fit(tokens)
    encoded = encoder_model(tokens)

    grams = NGramsFeaturizer(orders=tuple(range(1, conf.max_order + 1)))(encoded)
    counts = dict(NGramsCounts()(grams))
    # split unigram counts out (the estimator takes them separately)
    unigrams = {k[0]: v for k, v in counts.items() if len(k) == 1}
    ngram_counts = {k: v for k, v in counts.items() if len(k) > 1}

    model = StupidBackoffEstimator(unigrams, alpha=conf.alpha).fit(ngram_counts)

    # sanity scores: every seen ngram in (0, 1]
    n_scored = len(ngram_counts)
    result = {
        "num_tokens": model.num_tokens,
        "vocab_size": len(encoder_model.word_index),
        "num_ngrams": n_scored,
        "total_s": time.perf_counter() - t0,
    }
    logger.info(
        "StupidBackoff: %d tokens, %d vocab, %d ngrams scored",
        result["num_tokens"],
        result["vocab_size"],
        result["num_ngrams"],
    )
    return result, model, encoder_model


def main(argv=None) -> dict:
    conf = parse_config(StupidBackoffConfig, argv)
    if not conf.synthetic and not conf.train_location:
        raise SystemExit("need --train-location, or --synthetic N")
    return run(conf)[0]


if __name__ == "__main__":
    main()
