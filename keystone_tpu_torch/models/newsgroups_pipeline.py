"""20 Newsgroups text classification — port of
``keystone_tpu/models/newsgroups_pipeline.py`` (the reference's
``NewsgroupsPipeline.scala``): trim → lowercase → tokenize → n-grams
(1..n) → binary term frequency → the top-K sparse features made dense →
multinomial naive Bayes → argmax.

The featurizer is host code; the counts go to the device, where the naive
Bayes fit and the classification run. ``--corenlp`` featurizes with
:class:`~keystone_tpu_torch.ops.corenlp.CoreNLPFeatureExtractor`
(lemmas, entity types, sentence-bounded n-grams) instead.

Run on the card: ``python -m keystone_tpu_torch.models.newsgroups_pipeline
--synthetic 11314`` (or ``--train-location``/``--test-location``, each a
directory of class subdirectories); ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from keystone_tpu_torch.core.batching import pad_labels
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.newsgroups import CLASSES, TextData, load_newsgroups
from keystone_tpu_torch.ops.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.ops.nlp import LowerCase, NGramsFeaturizer, Tokenizer, Trim
from keystone_tpu_torch.ops.sparse import CommonSparseFeatures
from keystone_tpu_torch.ops.stats import TermFrequency
from keystone_tpu_torch.ops.util import MaxClassifier
from keystone_tpu_torch.parallel.mesh import shard_batch

logger = get_logger("keystone_tpu_torch.models.newsgroups")

NUM_CLASSES = len(CLASSES)

_SYNTH_VOCAB = [
    ["galaxy", "rocket", "orbit", "launch", "telescope"],
    ["goal", "hockey", "puck", "season", "playoff"],
    ["windows", "driver", "graphics", "monitor", "software"],
    ["engine", "motorcycle", "ride", "helmet", "brake"],
]


@dataclasses.dataclass
class NewsgroupsConfig:
    """Newsgroups workload (reference NewsgroupsConfig)."""

    train_location: str = arg(default="", help="dir of class subdirectories")
    test_location: str = arg(default="")
    n_grams: int = arg(default=2, help="use 1..n grams")
    common_features: int = arg(default=100_000, help="vocabulary cap")
    corenlp: bool = arg(
        default=False,
        help="featurize with CoreNLPFeatureExtractor (lemmatize + "
        "entity-type replacement, sentence-bounded n-grams) instead of "
        "the plain tokenizer chain",
    )
    synthetic: int = arg(default=0, help="if > 0, N synthetic documents")


def _load(conf: NewsgroupsConfig, which: str) -> TextData:
    """The split's documents: the class directories, or ``synthetic``
    train documents (a quarter of that for test) drawn from the same numpy
    seeds as the JAX package's."""
    if conf.synthetic:
        n = conf.synthetic if which == "train" else max(conf.synthetic // 4, 1)
        rng = np.random.default_rng(0 if which == "train" else 1)
        docs, labels = [], []
        for _ in range(n):
            label = int(rng.integers(0, len(_SYNTH_VOCAB)))
            words = list(rng.choice(_SYNTH_VOCAB[label], size=30)) + list(
                rng.choice(["the", "a", "and", "of"], size=10)
            )
            rng.shuffle(words)
            docs.append(" ".join(words))
            labels.append(label)
        return TextData(labels=np.asarray(labels, np.int32), data=docs)
    return load_newsgroups(conf.train_location if which == "train" else conf.test_location)


def make_featurizer(conf: NewsgroupsConfig) -> Transformer:
    """The host featurizer: documents → binary {n-gram: 1} dicts."""
    if conf.corenlp:
        from keystone_tpu_torch.ops.corenlp import CoreNLPFeatureExtractor

        return CoreNLPFeatureExtractor(orders=tuple(range(1, conf.n_grams + 1))) >> TermFrequency(
            fn=lambda x: 1
        )
    return (
        Trim()
        >> LowerCase()
        >> Tokenizer()
        >> NGramsFeaturizer(orders=tuple(range(1, conf.n_grams + 1)))
        >> TermFrequency(fn=lambda x: 1)
    )


def run(conf: NewsgroupsConfig, device=None, mesh=None) -> dict:
    """Featurize on the host, fit and evaluate on ``device`` (default: the
    card). With a ``mesh`` the rows are padded to its data axis."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    train, test = _load(conf, "train"), _load(conf, "test")
    n_train, n_test = len(train), len(test)

    featurizer_host = make_featurizer(conf)
    train_tf = featurizer_host(train.data)
    vectorizer = CommonSparseFeatures(conf.common_features).fit(train_tf)
    x_train = shard_batch(vectorizer(train_tf), mesh, device=device)
    y_train = pad_labels(train.labels, x_train.shape[0])
    synchronize(device)
    t_feat = time.perf_counter()

    model = NaiveBayesEstimator(num_classes=NUM_CLASSES).fit(x_train, y_train, n_valid=n_train)
    synchronize(device)
    t_fit = time.perf_counter()

    predict = model >> MaxClassifier()
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator(predict(x_train), y_train, n_valid=n_train)
    x_test = shard_batch(vectorizer(featurizer_host(test.data)), mesh, device=device)
    test_pred = predict(x_test)
    test_eval = evaluator(test_pred, pad_labels(test.labels, x_test.shape[0]), n_valid=n_test)
    synchronize(device)

    result = {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "n_train": n_train,
        "n_test": n_test,
        "vocab_size": len(vectorizer.feature_space),
        "total_s": time.perf_counter() - t0,
        "device": str(device),
        "featurize_s": t_feat - t0,
        "fit_s": t_fit - t_feat,
        "test_predictions": test_pred[:n_test].cpu().numpy(),
    }
    logger.info(
        "Newsgroups: train err %.4f, test err %.4f (vocab %d)\n%s",
        train_eval.error,
        test_eval.error,
        result["vocab_size"],
        test_eval.summary(list(CLASSES)) if not conf.synthetic else "",
    )
    return result


def main(argv=None, device=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(NewsgroupsConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.test_location):
        raise SystemExit("need --train-location AND --test-location, or --synthetic N")
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
