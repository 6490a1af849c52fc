"""NLP nodes — port of ``keystone_tpu/ops/nlp.py`` (the reference's
``nodes/nlp/``).

Tokenization, n-gram featurization and counting, the backoff indexers,
frequency encoding and the Stupid Backoff language model. Host code by
nature (string and dict work), copied; only the base classes change. The
card enters downstream, when counts become dense features
(``ops.sparse`` → naive Bayes).
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Iterable, Sequence

from keystone_tpu_torch.core.pipeline import Estimator, FunctionNode, Transformer


@dataclasses.dataclass(eq=False)
class Tokenizer(Transformer):
    """Split on a regex (reference StringUtils Tokenizer; default splits on
    punctuation + whitespace)."""

    sep: str = r"[^\w]+"

    def __call__(self, batch):
        pattern = re.compile(self.sep)
        return [[t for t in pattern.split(doc) if t] for doc in batch]


@dataclasses.dataclass(eq=False)
class Trim(Transformer):
    def __call__(self, batch):
        return [doc.strip() for doc in batch]


@dataclasses.dataclass(eq=False)
class LowerCase(Transformer):
    def __call__(self, batch):
        return [doc.lower() for doc in batch]


@dataclasses.dataclass(eq=False)
class NGramsFeaturizer(Transformer):
    """All n-grams for consecutive orders (reference NGramsFeaturizer).

    batch of token sequences → batch of lists of n-gram tuples.
    """

    orders: tuple = (1, 2)

    def __post_init__(self):
        orders = sorted(self.orders)
        if orders[0] < 1:
            raise ValueError(f"minimum order must be >= 1, got {orders[0]}")
        for a, b in zip(orders, orders[1:]):
            if b != a + 1:
                raise ValueError(f"orders must be consecutive, got {orders}")

    def __call__(self, batch):
        lo, hi = min(self.orders), max(self.orders)
        out = []
        for tokens in batch:
            grams = []
            n = len(tokens)
            for i in range(n - lo + 1):
                for order in range(lo, hi + 1):
                    if i + order > n:
                        break
                    grams.append(tuple(tokens[i : i + order]))
            out.append(grams)
        return out


@dataclasses.dataclass(eq=False)
class NGramsCounts(FunctionNode):
    """Count n-grams across the dataset (reference NGramsCounts).

    mode "default": aggregate counts globally, return list of
    ((ngram, count)) sorted by count descending. mode "noadd": per-document
    Counters without aggregation.
    """

    mode: str = "default"

    def __call__(self, batch_of_grams):
        if self.mode == "noadd":
            return [Counter(grams) for grams in batch_of_grams]
        if self.mode != "default":
            raise ValueError("mode must be 'default' or 'noadd'")
        counts: Counter = Counter()
        for grams in batch_of_grams:
            counts.update(grams)
        return sorted(counts.items(), key=lambda kv: -kv[1])


class NGramIndexer:
    """Tuple-based indexer (reference NGramIndexerImpl): position 0 is the
    farthest context word, the last position is the current word."""

    min_order = 1
    max_order = 64

    @staticmethod
    def pack(words: Sequence) -> tuple:
        return tuple(words)

    @staticmethod
    def unpack(ngram: tuple, pos: int):
        return ngram[pos]

    @staticmethod
    def remove_farthest_word(ngram: tuple) -> tuple:
        return ngram[1:]

    @staticmethod
    def remove_current_word(ngram: tuple) -> tuple:
        return ngram[:-1]

    @staticmethod
    def ngram_order(ngram: tuple) -> int:
        return len(ngram)


class NaiveBitPackIndexer:
    """Pack up to a trigram of word ids < 2^20 into one int (reference
    NaiveBitPackIndexer bit layout: [4 control bits][farthest]...[current],
    left-aligned; control 00/01/10 = uni/bi/trigram)."""

    min_order = 1
    max_order = 3
    _MASK = (1 << 20) - 1

    @staticmethod
    def pack(ngram: Sequence[int]) -> int:
        for w in ngram:
            if w >= 1 << 20:
                raise ValueError(f"word id {w} >= 2^20")
        n = len(ngram)
        if n == 1:
            return ngram[0] << 40
        if n == 2:
            return (ngram[1] << 20) | (ngram[0] << 40) | (1 << 60)
        if n == 3:
            return ngram[2] | (ngram[1] << 20) | (ngram[0] << 40) | (1 << 61)
        raise ValueError("ngram order must be in {1, 2, 3}")

    @classmethod
    def unpack(cls, ngram: int, pos: int) -> int:
        if pos == 0:
            return (ngram >> 40) & cls._MASK
        if pos == 1:
            return (ngram >> 20) & cls._MASK
        if pos == 2:
            return ngram & cls._MASK
        raise ValueError("pos must be in {0, 1, 2}")

    @classmethod
    def ngram_order(cls, ngram: int) -> int:
        control = ngram >> 60
        if control == 0:
            return 1
        if control == 1:
            return 2
        if control == 2:
            return 3
        raise ValueError(f"bad control bits {control}")

    @classmethod
    def remove_farthest_word(cls, ngram: int) -> int:
        order = cls.ngram_order(ngram)
        if order == 3:
            w1, w2 = cls.unpack(ngram, 1), cls.unpack(ngram, 2)
            return cls.pack([w1, w2])
        if order == 2:
            return cls.pack([cls.unpack(ngram, 1)])
        raise ValueError("cannot remove from a unigram")

    @classmethod
    def remove_current_word(cls, ngram: int) -> int:
        order = cls.ngram_order(ngram)
        if order == 3:
            return cls.pack([cls.unpack(ngram, 0), cls.unpack(ngram, 1)])
        if order == 2:
            return cls.pack([cls.unpack(ngram, 0)])
        raise ValueError("cannot remove from a unigram")


def initial_bigram_shard(ngram, n_shards: int, indexer=NGramIndexer) -> int:
    """Shard id from the first two context words (reference
    InitialBigramPartitioner): co-locates every n-gram with its backoff
    context so scoring is shard-local."""
    if indexer.ngram_order(ngram) > 1:
        key = (indexer.unpack(ngram, 0), indexer.unpack(ngram, 1))
        return hash(key) % n_shards
    return 0


@dataclasses.dataclass(eq=False)
class WordFrequencyTransformer(Transformer):
    """Token → frequency-ordered id; OOV → −1 (reference
    WordFrequencyTransformer)."""

    word_index: dict = dataclasses.field(default_factory=dict)
    unigram_counts: dict = dataclasses.field(default_factory=dict)

    OOV = -1

    def __call__(self, batch):
        idx = self.word_index
        return [[idx.get(w, self.OOV) for w in doc] for doc in batch]


class WordFrequencyEncoder(Estimator):
    """Fit the frequency-sorted vocabulary (reference WordFrequencyEncoder:
    ids respect descending count order; ties broken deterministically)."""

    def fit(self, data: Iterable[Sequence[str]]) -> WordFrequencyTransformer:
        counts: Counter = Counter()
        for doc in data:
            counts.update(doc)
        ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        word_index = {w: i for i, (w, _) in enumerate(ordered)}
        unigrams = {word_index[w]: c for w, c in counts.items()}
        return WordFrequencyTransformer(
            word_index=word_index, unigram_counts=unigrams
        )


class StupidBackoffModel:
    """Brants et al. Stupid Backoff scorer (reference StupidBackoffModel).

    Scores are un-normalized:
    ``S(w|ctx) = freq(ctx·w)/freq(ctx)`` when seen, else ``α·S(w|shorter
    ctx)``; ``S(w) = freq(w)/N``.
    """

    def __init__(
        self,
        ngram_counts: dict,
        unigram_counts: dict,
        num_tokens: int,
        alpha: float = 0.4,
        indexer=NGramIndexer,
    ):
        self.ngram_counts = ngram_counts
        self.unigram_counts = unigram_counts
        self.num_tokens = num_tokens
        self.alpha = alpha
        self.indexer = indexer

    def score(self, ngram) -> float:
        return self._score(1.0, ngram, self.ngram_counts.get(ngram, 0))

    def _score(self, accum: float, ngram, freq: int) -> float:
        ix = self.indexer
        order = ix.ngram_order(ngram)
        if order == 1:
            count = (
                freq
                if freq
                else self.unigram_counts.get(ix.unpack(ngram, 0), 0)
            )
            return accum * count / self.num_tokens
        if freq != 0:
            context = ix.remove_current_word(ngram)
            if order != 2:
                context_freq = self.ngram_counts.get(context, 0)
            else:
                context_freq = self.unigram_counts.get(ix.unpack(context, 0), 0)
            return accum * freq / context_freq
        backoffed = ix.remove_farthest_word(ngram)
        return self._score(
            self.alpha * accum,
            backoffed,
            self.ngram_counts.get(backoffed, 0),
        )

    def scores_by_shard(self, n_shards: int) -> list[dict]:
        """Score every seen n-gram, grouped by its backoff-context shard —
        each shard's scoring touches only shard-local counts (the invariant
        the reference's InitialBigramPartitioner provides)."""
        shards: list[dict] = [dict() for _ in range(n_shards)]
        for ngram in self.ngram_counts:
            shards[initial_bigram_shard(ngram, n_shards, self.indexer)][
                ngram
            ] = self.score(ngram)
        return shards


class StupidBackoffEstimator(Estimator):
    """Fit from (ngram, count) pairs + unigram counts (reference
    StupidBackoffEstimator)."""

    def __init__(self, unigram_counts: dict, alpha: float = 0.4):
        self.unigram_counts = unigram_counts
        self.alpha = alpha

    def fit(self, ngram_counts) -> StupidBackoffModel:
        if not isinstance(ngram_counts, dict):
            ngram_counts = dict(ngram_counts)
        num_tokens = sum(self.unigram_counts.values())
        model = StupidBackoffModel(
            ngram_counts,
            self.unigram_counts,
            num_tokens,
            self.alpha,
        )
        for ngram, _ in ngram_counts.items():
            s = model.score(ngram)
            if not (0.0 <= s <= 1.0):
                raise ValueError(f"score {s} not in [0,1] for {ngram}")
        return model
