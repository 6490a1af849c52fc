"""keystone_tpu_torch's text stack against the JAX package's: the string
nodes, n-grams and their counts, the indexers, the frequency encoder,
Stupid Backoff, the sparse vectorizers, the CoreNLP-style extractor, the
Newsgroups loader, naive Bayes and both text workloads, on the same
numpy-seeded documents.

Host code is held exactly: equal tokens, counts, vocabularies and Stupid
Backoff scores. Naive Bayes is a float32 product of counts: 1e-6 of
max|log θ|."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.loaders import newsgroups as j_loader  # noqa: E402
from keystone_tpu.models import newsgroups_pipeline as j_ng  # noqa: E402
from keystone_tpu.models import stupid_backoff_pipeline as j_sb  # noqa: E402
from keystone_tpu.ops import corenlp as j_corenlp  # noqa: E402
from keystone_tpu.ops import naive_bayes as j_nb  # noqa: E402
from keystone_tpu.ops import nlp as j_nlp  # noqa: E402
from keystone_tpu.ops import sparse as j_sparse  # noqa: E402
from keystone_tpu.ops.stats import TermFrequency as JTermFrequency  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.loaders import newsgroups as loader  # noqa: E402
from keystone_tpu_torch.models import newsgroups_pipeline as ng  # noqa: E402
from keystone_tpu_torch.models import stupid_backoff_pipeline as sb  # noqa: E402
from keystone_tpu_torch.ops import corenlp, naive_bayes, nlp, sparse  # noqa: E402
from keystone_tpu_torch.ops.stats import TermFrequency  # noqa: E402

TEXTS = [
    "  Hello, World!  The U.S. economy grew 3.5% in 1999; Mr. Smith said so.",
    "Dr. John Baker went to Washington on Monday. He bought three cars!",
    "Running runners ran quickly; the children were playing with mice.",
    "IBM and Acme Corp reported better results than NASA's labs in March.",
    "news species series: indeed, the wolves' knives and shelves.",
    "",
]


def _docs(seed, n, vocab=("a", "b", "c", "d", "e", "f"), lo=3, hi=15):
    rng = np.random.default_rng(seed)
    return [list(rng.choice(vocab, size=rng.integers(lo, hi))) for _ in range(n)]


def test_string_nodes_and_ngrams_match_jax():
    for ours, theirs in ((nlp.Trim(), j_nlp.Trim()), (nlp.LowerCase(), j_nlp.LowerCase()),
                         (nlp.Tokenizer(), j_nlp.Tokenizer()),
                         (nlp.Tokenizer(sep=r"\s+"), j_nlp.Tokenizer(sep=r"\s+")),
                         (nlp.Trim() >> nlp.LowerCase() >> nlp.Tokenizer(),
                          j_nlp.Trim() >> j_nlp.LowerCase() >> j_nlp.Tokenizer())):
        assert ours(TEXTS) == theirs(TEXTS)
    docs = _docs(0, 20)
    for orders in ((1,), (1, 2), (2, 3), (1, 2, 3)):
        grams = nlp.NGramsFeaturizer(orders=orders)(docs)
        assert grams == j_nlp.NGramsFeaturizer(orders=orders)(docs)
        assert nlp.NGramsCounts()(grams) == j_nlp.NGramsCounts()(grams)
        assert nlp.NGramsCounts(mode="noadd")(grams) == j_nlp.NGramsCounts(mode="noadd")(grams)
    for bad in ((0, 1), (1, 3)):
        with pytest.raises(ValueError):
            nlp.NGramsFeaturizer(orders=bad)
    with pytest.raises(ValueError):
        nlp.NGramsCounts(mode="bad")([])


def test_indexers_and_shards_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        words = [int(w) for w in rng.integers(0, 1 << 20, size=int(rng.integers(1, 4)))]
        packed = nlp.NaiveBitPackIndexer.pack(words)
        assert packed == j_nlp.NaiveBitPackIndexer.pack(words)
        ix, jx = nlp.NaiveBitPackIndexer, j_nlp.NaiveBitPackIndexer
        assert ix.ngram_order(packed) == jx.ngram_order(packed) == len(words)
        if len(words) > 1:
            assert ix.remove_farthest_word(packed) == jx.remove_farthest_word(packed)
            assert ix.remove_current_word(packed) == jx.remove_current_word(packed)
        for n_shards in (1, 3, 8):
            assert nlp.initial_bigram_shard(packed, n_shards, ix) == j_nlp.initial_bigram_shard(
                packed, n_shards, jx)
            t = tuple(words)
            assert nlp.initial_bigram_shard(t, n_shards) == j_nlp.initial_bigram_shard(t, n_shards)
    with pytest.raises(ValueError):
        nlp.NaiveBitPackIndexer.pack([1 << 20])


def test_word_frequency_encoder_matches_jax():
    docs = _docs(2, 40, vocab=tuple("abcdefghij"))
    ours, theirs = nlp.WordFrequencyEncoder().fit(docs), j_nlp.WordFrequencyEncoder().fit(docs)
    assert ours.word_index == theirs.word_index
    assert ours.unigram_counts == theirs.unigram_counts
    probe = docs[:5] + [["zz", "a"]]
    assert ours(probe) == theirs(probe)
    assert ours([["zz"]]) == [[nlp.WordFrequencyTransformer.OOV]]


def _stupid_backoff(pkg, docs):
    grams = pkg.NGramsFeaturizer(orders=(1, 2, 3))(docs)
    counts = dict(pkg.NGramsCounts()(grams))
    unigrams = {k[0]: v for k, v in counts.items() if len(k) == 1}
    ngrams = {k: v for k, v in counts.items() if len(k) > 1}
    return pkg.StupidBackoffEstimator(unigrams, alpha=0.4).fit(ngrams), ngrams


def test_stupid_backoff_scores_equal_jax():
    """Every seen n-gram, and unseen ones that back off, score exactly as
    in the JAX package; the shards hold the same scores."""
    encoded = [[int(w) for w in d] for d in _docs(3, 60, vocab=tuple(range(9)))]
    ours, ngrams = _stupid_backoff(nlp, encoded)
    theirs, _ = _stupid_backoff(j_nlp, encoded)
    rng = np.random.default_rng(4)
    probes = list(ngrams) + [tuple(int(w) for w in rng.integers(0, 9, size=int(k)))
                             for k in rng.integers(1, 4, size=300)]
    for g in probes:
        assert ours.score(g) == theirs.score(g), g
    assert ours.scores_by_shard(4) == theirs.scores_by_shard(4)
    assert ours.num_tokens == theirs.num_tokens


def test_term_frequency_and_sparse_features_match_jax():
    """Counts, the top-K feature order with its ``(-count, repr)`` tie
    break, and the dense vectors."""
    docs = _docs(5, 50, vocab=("x", "y", "z", "w", "v", "u", "t"))
    for fn in (lambda x: x, lambda x: 1, np.log1p):
        tf, jtf = TermFrequency(fn=fn)(docs), JTermFrequency(fn=fn)(docs)
        assert tf == jtf
        for k in (1, 3, 100):
            vec = sparse.CommonSparseFeatures(k).fit(tf)
            jvec = j_sparse.CommonSparseFeatures(k).fit(jtf)
            assert vec.feature_space == jvec.feature_space
            out = vec(tf)
            assert isinstance(out, np.ndarray) and out.dtype == np.float32
            np.testing.assert_array_equal(out, np.asarray(jvec(jtf)))
        assert sparse.AllSparseFeatures().fit(tf).feature_space == j_sparse.AllSparseFeatures().fit(
            jtf).feature_space
    pairs = [[("a", 2.0), ("b", 1.0)], [("b", 3.0)]]
    np.testing.assert_array_equal(sparse.AllSparseFeatures().fit(pairs)(pairs),
                                  np.asarray(j_sparse.AllSparseFeatures().fit(pairs)(pairs)))


@pytest.mark.parametrize("n_valid", [None, 50])
def test_naive_bayes_matches_jax(n_valid):
    rng = np.random.default_rng(6)
    n, d, c = 60, 30, 4
    x = rng.integers(0, 5, size=(n, d)).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[3] = c + 2  # out of range: a zero one-hot row, as jax.nn.one_hot gives
    model = naive_bayes.NaiveBayesEstimator(num_classes=c, lam=0.5).fit(
        torch.from_numpy(x), labels, n_valid=n_valid)
    want = j_nb.NaiveBayesEstimator(num_classes=c, lam=0.5).fit(jnp.asarray(x), labels,
                                                                n_valid=n_valid)
    for got, ref in ((model.log_pi, want.log_pi), (model.log_theta, want.log_theta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6 * float(np.abs(np.asarray(ref)).max()))
    post = model(torch.from_numpy(x)).numpy()
    want_post = np.asarray(want(jnp.asarray(x)))
    np.testing.assert_allclose(post, want_post, rtol=0, atol=1e-6 * np.abs(want_post).max())
    conv = convert.naive_bayes_model(np.asarray(want.log_pi), np.asarray(want.log_theta),
                                     device="cpu")
    np.testing.assert_array_equal(conv(torch.from_numpy(x)).argmax(1).numpy(),
                                  want_post.argmax(1))


def test_corenlp_matches_jax():
    words = ("running ran better children mice stores visited hoped hopped created jumped "
             "news puppies clues indices analyses wolves went was quickly happily").split()
    assert [corenlp.default_lemmatize(w) for w in words] == [
        j_corenlp.default_lemmatize(w) for w in words]
    for text in TEXTS:
        sentences = corenlp.split_sentences(text)
        assert sentences == j_corenlp.split_sentences(text)
        for toks in sentences:
            assert corenlp.tag_entities(toks) == j_corenlp.tag_entities(toks)
    for orders in ((1,), (1, 2), (1, 2, 3)):
        got = corenlp.CoreNLPFeatureExtractor(orders=orders)(TEXTS)
        assert got == j_corenlp.CoreNLPFeatureExtractor(orders=orders)(TEXTS)
    assert corenlp.CoreNLPFeatureExtractor()(TEXTS[1]) == j_corenlp.CoreNLPFeatureExtractor()(
        TEXTS[1])


def test_newsgroups_loader_matches_jax(tmp_path):
    assert loader.CLASSES == j_loader.CLASSES
    for i, cls in enumerate(("sci.space", "rec.autos", "alt.atheism")):
        os.makedirs(tmp_path / cls)
        for j in range(3):
            (tmp_path / cls / f"{j:03d}").write_text(f"post {i} {j}\n\xe9")
    got, want = loader.load_newsgroups(str(tmp_path)), j_loader.load_newsgroups(str(tmp_path))
    assert got.data == want.data and len(got) == 9
    np.testing.assert_array_equal(got.labels, want.labels)
    with pytest.raises(FileNotFoundError):
        loader.load_newsgroups(str(tmp_path / "sci.space"))


@pytest.mark.parametrize("corenlp_featurizer", [False, True])
def test_newsgroups_run_matches_jax(corenlp_featurizer):
    """The synthetic documents, the vocabulary and the errors equal the JAX
    package's run; on the same counts the test predictions are the JAX
    model's."""
    conf = dict(synthetic=160, n_grams=2, corenlp=corenlp_featurizer)
    for which in ("train", "test"):
        got, want = ng._load(ng.NewsgroupsConfig(**conf), which), j_ng._load(
            j_ng.NewsgroupsConfig(**conf), which)
        assert got.data == want.data
        np.testing.assert_array_equal(got.labels, want.labels)
    res = ng.run(ng.NewsgroupsConfig(**conf), device="cpu")
    j_res = j_ng.run(j_ng.NewsgroupsConfig(**conf))
    assert set(j_res) <= set(res) and res["device"] == "cpu"
    for key in ("train_error", "test_error", "n_train", "n_test", "vocab_size"):
        assert res[key] == j_res[key], key
    train, test = j_ng._load(j_ng.NewsgroupsConfig(**conf), "train"), j_ng._load(
        j_ng.NewsgroupsConfig(**conf), "test")
    feat = ng.make_featurizer(ng.NewsgroupsConfig(**conf))
    vec = sparse.CommonSparseFeatures(100_000).fit(feat(train.data))
    model = j_nb.NaiveBayesEstimator(num_classes=ng.NUM_CLASSES).fit(
        jnp.asarray(vec(feat(train.data))), train.labels)
    want = np.asarray(model(jnp.asarray(vec(feat(test.data))))).argmax(1)
    np.testing.assert_array_equal(res["test_predictions"], want)


def test_stupid_backoff_run_matches_jax():
    result, model, encoder = sb.run(sb.StupidBackoffConfig(synthetic=300))
    j_result, j_model, j_encoder = j_sb.run(j_sb.StupidBackoffConfig(synthetic=300))
    for key in ("num_tokens", "vocab_size", "num_ngrams"):
        assert result[key] == j_result[key], key
    assert encoder.word_index == j_encoder.word_index
    assert model.ngram_counts == j_model.ngram_counts
    for g in model.ngram_counts:
        assert model.score(g) == j_model.score(g)
    assert sb.main(["--synthetic", "50"])["num_ngrams"] > 0
