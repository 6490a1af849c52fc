"""keystone_tpu_torch's streaming ingestion against the JAX package's
(``loaders/streaming.py``, ``loaders/imagenet_stream.py``,
``plan/executor.apply_shared``, ``core/staging.tune_active``): tars the
test writes itself, numpy-seeded rows and images through both packages.

Tolerances: decode, sharding, the reservoir and the synthetic source
exactly (the same host code and numpy draws); featurized streams equal
to ``apply_in_chunks`` of the same function bit for bit (the same rows
through the same function), and within 1e-5 of max|out| of the JAX
package's (float32 sums in another order)."""

import io
import os
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.loaders import imagenet_stream as j_stream_src  # noqa: E402
from keystone_tpu.loaders import streaming as j_streaming  # noqa: E402
from keystone_tpu.models import imagenet_sift_lcs_fv as j_imnet  # noqa: E402
from keystone_tpu.plan import executor as j_executor  # noqa: E402
from keystone_tpu_torch.core import staging  # noqa: E402
from keystone_tpu_torch.core.batching import apply_in_chunks  # noqa: E402
from keystone_tpu_torch.core.pipeline import Pipeline  # noqa: E402
from keystone_tpu_torch.loaders import imagenet_stream, streaming  # noqa: E402
from keystone_tpu_torch.models import imagenet_sift_lcs_fv as imnet  # noqa: E402
from keystone_tpu_torch.observe import metrics  # noqa: E402
from keystone_tpu_torch.ops.images import PixelScaler  # noqa: E402
from keystone_tpu_torch.ops.stats import LinearRectifier  # noqa: E402
from keystone_tpu_torch.parallel.mesh import create_mesh  # noqa: E402
from keystone_tpu_torch.plan import executor  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jpeg(arr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _make_tar(path, entries):
    with tarfile.open(path, "w") as tf:
        for name, data in entries:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture
def tars(tmp_path):
    """Three tars of 24² JPEGs named ``nTT_i.jpg``; the second holds one
    undecodable entry."""
    rng = np.random.default_rng(0)
    paths = []
    for t in range(3):
        entries = [(f"n{t:02d}_{i}.jpg", _jpeg(rng.integers(0, 255, (24, 24, 3)).astype(np.uint8)))
                   for i in range(7)]
        if t == 1:
            entries.insert(3, ("n01_bad.jpg", b"\xff\xd8not a jpeg"))
        p = str(tmp_path / f"part{t}.tar")
        _make_tar(p, entries)
        paths.append(p)
    return paths


def _label_of(name):
    return int(os.path.basename(name)[1:3])


def _batches(mod, tars, **kw):
    return list(mod.iter_tar_image_batches(tars, target_size=16, **kw))


@pytest.mark.parametrize("batch_size", [5, 64])
def test_iter_tar_batches_match_jax(tars, batch_size):
    """The same names, pixels, labels and batch boundaries (every
    ``batch_size`` entries, the undecodable one dropped and counted)."""
    counter = metrics.get_registry().counter("ingest_decode_failures", loader="streaming")
    before = counter.value
    got = _batches(streaming, tars, batch_size=batch_size, label_of=_label_of, workers=3)
    want = _batches(j_streaming, tars, batch_size=batch_size, label_of=_label_of, workers=3)
    assert counter.value == before + 1
    assert len(got) == len(want)
    for (gn, gi, gl), (wn, wi, wl) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    names = [n for b in got for n in b[0]]
    assert len(names) == 21 and "n01_bad.jpg" not in names
    assert all(b[1].shape[1:] == (16, 16, 3) for b in got)


def test_iter_tar_batches_process_sharding(tars):
    """Tar files go round-robin to processes: disjoint shards covering
    every image, each equal to the JAX package's shard."""
    shards = []
    for pi in range(2):
        kw = dict(batch_size=64, process_index=pi, process_count=2)
        got = [n for b in _batches(streaming, tars, **kw) for n in b[0]]
        assert got == [n for b in _batches(j_streaming, tars, **kw) for n in b[0]]
        shards.append(got)
    assert len(shards[0]) == 14 and len(shards[1]) == 7
    assert not set(shards[0]) & set(shards[1])


def test_iter_tar_batches_skip_unmapped_labels(tars):
    got = _batches(streaming, tars, batch_size=64, label_of=lambda n: -1 if "n00" in n else 3)
    labels = np.concatenate([b[2] for b in got])
    assert len(labels) == 14 and (labels == 3).all()


def test_ingest_frontier_keeps_order_and_reraises():
    got = list(streaming.ingest_frontier(range(50), lambda i: i * i, workers=lambda: 4))
    assert got == [i * i for i in range(50)]

    def boom(i):
        if i == 7:
            raise ValueError("seven")
        return i

    it = streaming.ingest_frontier(range(20), boom, workers=3)
    assert [next(it) for _ in range(7)] == list(range(7))
    with pytest.raises(ValueError, match="seven"):
        next(it)


@pytest.mark.parametrize("capacity,seed", [(200, 0), (37, 5), (1000, 2)])
def test_column_reservoir_bit_for_bit(capacity, seed):
    """The same batches through both reservoirs keep the same rows."""
    rng = np.random.default_rng(seed)
    ours, theirs = streaming.ColumnReservoir(capacity, seed), j_streaming.ColumnReservoir(capacity, seed)
    for size in (50, 300, 7, 0, 640, 128):
        rows = rng.normal(size=(size, 3)).astype(np.float32)
        ours.add(rows)
        theirs.add(rows)
    np.testing.assert_array_equal(ours.sample(), theirs.sample())
    assert (ours.seen, ours.filled) == (theirs.seen, theirs.filled)
    assert streaming.ColumnReservoir(5).sample().shape == (0, 0)


def _ragged_batches(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 6, 5)).astype(np.float32) for n in (13, 8, 1, 21)]


def _feat_fn(x):
    return torch.relu(x).sum(-1) * 0.5


@pytest.mark.parametrize("prefetch,stage_depth", [(2, None), (0, 0)])
def test_featurize_stream_matches_apply_in_chunks(prefetch, stage_depth):
    batches = _ragged_batches(1)
    got = streaming.featurize_stream(iter(batches), _feat_fn, chunk_size=8, device="cpu",
                                     prefetch=prefetch, stage_depth=stage_depth)
    want = torch.cat([apply_in_chunks(_feat_fn, b, 8, CPU) for b in batches]).numpy()
    np.testing.assert_array_equal(got, want)
    j_got = j_streaming.featurize_stream(
        iter(batches), lambda x: jnp.maximum(x, 0).sum(-1) * 0.5, chunk_size=8)
    assert _rel(got, np.asarray(j_got)) <= TOL
    assert streaming.featurize_stream(iter([]), _feat_fn, chunk_size=8, device="cpu").shape == (0, 0)


def test_featurize_stream_on_a_mesh_pads_to_its_data_axis():
    """A mesh of 3 positions rounds the chunk of 8 up to 9 rows; the
    output is the same."""
    batches = _ragged_batches(2)
    mesh = create_mesh(devices=["cpu"] * 3)
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return _feat_fn(x)

    got = streaming.featurize_stream(iter(batches), fn, chunk_size=8, mesh=mesh)
    assert set(seen) == {9}
    want = torch.cat([_feat_fn(torch.from_numpy(b)) for b in batches]).numpy()
    np.testing.assert_array_equal(got, want)


def test_prefetch_batches_propagates_and_releases():
    def bad():
        yield np.zeros(2)
        raise RuntimeError("decode exploded")

    it = streaming.prefetch_batches(bad(), depth=1)
    next(it)
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(it)
    assert [int(b[0]) for b in streaming.prefetch_batches((np.full(1, i) for i in range(5)))] == \
        list(range(5))


def _conf(mod, **kw):
    base = dict(synthetic=40, synthetic_classes=5, image_size=32, stream_batch=16,
                label_noise=0.25)
    base.update(kw)
    return mod.ImageNetConfig(**base)


@pytest.mark.parametrize("which", ["train", "test"])
def test_synthetic_source_equals_jax(which):
    got = list(imagenet_stream.synthetic_source(_conf(imnet), which)())
    want = list(j_stream_src.synthetic_source(_conf(j_imnet), which)())
    assert len(got) == len(want) == (3 if which == "train" else 1)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    labels = np.arange(30) % 6
    np.testing.assert_array_equal(imagenet_stream.render_classes(labels, 6, 0.4, rng_a),
                                  j_stream_src.render_classes(labels, 6, 0.4, rng_b))
    with pytest.raises(ValueError, match="top-1 error floor"):
        imagenet_stream.render_classes(labels, 6, 1.5, rng_a)


def test_tar_source_shards_by_torch_distributed(tars, tmp_path, monkeypatch):
    """One process streams every tar; as rank 1 of 2 (read from an
    initialized ``torch.distributed`` group) it streams the second file
    only, and assembling across processes gathers every rank's rows."""
    label_map = tmp_path / "map.txt"
    label_map.write_text("n00 0\nn01 1\nn02 2\n")
    conf = _conf(imnet, synthetic=0, train_location=str(tmp_path), label_map=str(label_map),
                 stream_batch=4, image_size=16)
    alone = list(imagenet_stream.tar_source(conf, "train")())
    assert sum(len(lab) for _, lab in alone) == 21
    assert imagenet_stream.process_index_count() == (0, 1)
    f = np.ones((3, 2), np.float32)
    assert imagenet_stream.assemble_global(f, np.arange(3))[0] is f

    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    second = list(imagenet_stream.tar_source(conf, "train")())
    assert np.concatenate([lab for _, lab in second]).tolist() == [1] * 7
    # across processes every rank's rows are gathered in rank order
    # (tests/test_torch_multihost.py runs it over two real processes)
    from keystone_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "all_gather_rows", lambda t: torch.cat([t, t]))
    got_f, got_y = imagenet_stream.assemble_global(f, np.arange(3))
    np.testing.assert_array_equal(got_f, np.concatenate([f, f]))
    np.testing.assert_array_equal(got_y, np.concatenate([np.arange(3)] * 2))


def test_apply_shared_matches_branches_applied_apart():
    """One prefix apply a chunk feeding two branches gives each branch's
    own chunked apply, counts one shared-prefix apply, and equals the JAX
    package's."""
    x = np.random.default_rng(4).uniform(0, 255, size=(19, 4, 4, 3)).astype(np.float32)
    branch_a = LinearRectifier(max_val=0.5)
    branch_b = Pipeline.of(PixelScaler())

    def branch_c(s):
        return s.sum(dim=(1, 2))

    counter = metrics.get_registry().counter("plan_shared_prefix_applies")
    before = counter.value
    got = executor.apply_shared(PixelScaler(), (branch_a, branch_c), x, chunk_size=8, device="cpu")
    assert counter.value == before + 1
    for out, branch in zip(got, (branch_a, branch_c)):
        want = apply_in_chunks(lambda b: branch(PixelScaler()(b)), x, 8, CPU)
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    one = executor.apply_shared(PixelScaler(), (branch_c,), x, chunk_size=8, device="cpu")
    assert counter.value == before + 1  # one branch shares nothing
    j_got = j_executor.apply_shared(lambda b: b / 255.0, (lambda s: s.sum(axis=(1, 2)),),
                                    jnp.asarray(x), chunk_size=8)
    assert _rel(one[0].numpy(), np.asarray(j_got[0])) <= TOL
    assert executor.shared_prefix_nodes([]) == []
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
    from keystone_tpu_torch.ops.linear import LinearMapEstimator

    scale = PixelScaler()
    chains = [ChainedLabelEstimator(prefix=Pipeline.of(scale, branch), est=LinearMapEstimator())
              for branch in (branch_a, branch_b)]
    assert executor.shared_prefix_nodes(chains) == [scale]


def test_tune_active_is_off_and_refuses_the_tuner(monkeypatch):
    """Off unless asked; ``KEYSTONE_TUNE=1`` builds the port's autotuner
    (before the tuner was ported it raised naming ROADMAP A8)."""
    from keystone_tpu_torch.plan import tune

    monkeypatch.delenv("KEYSTONE_TUNE", raising=False)
    monkeypatch.delenv("KEYSTONE_STAGE_DEPTH", raising=False)
    tune.reset()
    assert staging.tune_active() is None
    monkeypatch.setenv("KEYSTONE_TUNE", "1")
    tune.reset()  # activation is env-lazy: re-arm after the flip
    try:
        tuner = staging.tune_active()
        assert isinstance(tuner, tune.Autotuner)
        assert set(tuner.knobs) == {"stage_depth", "ingest_workers"}
    finally:
        tune.reset()
    monkeypatch.setenv("KEYSTONE_INGEST_WORKERS", "5")
    assert streaming.default_ingest_workers() == 5 == j_streaming.default_ingest_workers()
