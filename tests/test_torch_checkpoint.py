"""keystone_tpu_torch's checkpoint and resume (``core/checkpoint.py``):
``resumable_fit`` against a direct fit and the JAX package's
``resumable_fit`` on the same numpy-seeded data; an interrupted fit
resumes onto the uninterrupted run's bits; the identity checks (an
over-trained checkpoint, changed hyperparameters, different data; a
longer schedule is accepted); a torn newest step falls back to the
previous one; ``TrainCheckpointer``'s template checks.

Tolerances: a chunked fit warm-starts each chunk and recomputes the
residual from the model, so it ends within 1e-5 of max|W| of a direct
fit (float32 products in another order), and within 1e-5 of the JAX
package's chunked fit. An interrupted-and-resumed run repeats the
uninterrupted chunked run's operations, so the two are equal bit for
bit."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.core import checkpoint as j_ckpt  # noqa: E402
from keystone_tpu.ops import linear as jl  # noqa: E402
from keystone_tpu.ops import weighted_linear as jw  # noqa: E402
from keystone_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from keystone_tpu_torch.observe import metrics  # noqa: E402
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator  # noqa: E402
from keystone_tpu_torch.ops.weighted_linear import BlockWeightedLeastSquaresEstimator  # noqa: E402

TOL = 1e-5


def _data(seed=0, n=80, d=12, c=4):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, c, size=n)
    centers = rng.normal(size=(c, d)) * 2
    a = (centers[cls] + rng.normal(size=(n, d))).astype(np.float32)
    y = -np.ones((n, c), np.float32)
    y[np.arange(n), cls] = 1.0
    return a, y


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _models_rel(m1, m2) -> float:
    xs = max(_rel(np.asarray(x1), np.asarray(x2)) for x1, x2 in zip(m1.xs, m2.xs))
    return max(xs, _rel(np.asarray(m1.b), np.asarray(m2.b)))


def _models_equal(m1, m2) -> bool:
    return all(torch.equal(x1, x2) for x1, x2 in zip(m1.xs, m2.xs)) and torch.equal(m1.b, m2.b)


def test_resumable_fit_equals_direct_and_jax(tmp_path):
    a, y = _data()
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)
    est = BlockLeastSquaresEstimator(block_size=5, num_iter=4, lam=0.1)
    model = ckpt.resumable_fit(est, ta, ty, checkpoint_dir=str(tmp_path / "ck"), every=2)
    assert _models_rel(model, est.fit(ta, ty)) <= TOL
    theirs = j_ckpt.resumable_fit(
        jl.BlockLeastSquaresEstimator(block_size=5, num_iter=4, lam=0.1),
        jnp.asarray(a), jnp.asarray(y), checkpoint_dir=str(tmp_path / "jck"), every=2,
    )
    assert _models_rel(model, theirs) <= TOL
    leaves, step = ckpt.read_step(str(tmp_path / "ck"))
    assert step == 4 and torch.equal(leaves[0], model.xs[0])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "digests_2.json", "digests_4.json", "fit_meta.json", "step_2", "step_4"]


def test_interrupted_fit_resumes_onto_the_uninterrupted_bits(tmp_path):
    a, y = _data(1)
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)
    est = BlockWeightedLeastSquaresEstimator(
        block_size=6, num_iter=4, lam=0.1, mixture_weight=0.3, class_chunk=2)
    whole = ckpt.resumable_fit(est, ta, ty, checkpoint_dir=str(tmp_path / "whole"), every=1)
    # "crashes" after two passes, then the full fit reruns on the directory
    ck = str(tmp_path / "ck")
    ckpt.resumable_fit(dataclasses.replace(est, num_iter=2), ta, ty, checkpoint_dir=ck, every=1)
    resumed = ckpt.resumable_fit(est, ta, ty, checkpoint_dir=ck, every=1)
    assert _models_equal(resumed, whole)
    assert _models_rel(resumed, est.fit(ta, ty)) <= TOL
    theirs = j_ckpt.resumable_fit(
        jw.BlockWeightedLeastSquaresEstimator(
            block_size=6, num_iter=4, lam=0.1, mixture_weight=0.3, class_chunk=2),
        jnp.asarray(a), jnp.asarray(y), checkpoint_dir=str(tmp_path / "jck"), every=1,
    )
    assert _models_rel(resumed, theirs) <= TOL


def test_identity_checks(tmp_path):
    a, y = _data(2)
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)
    est = BlockLeastSquaresEstimator(block_size=5, num_iter=4, lam=0.1)
    ck = str(tmp_path / "ck")
    ckpt.resumable_fit(est, ta, ty, checkpoint_dir=ck, every=4)
    with pytest.raises(ValueError, match="over-trained"):
        ckpt.resumable_fit(dataclasses.replace(est, num_iter=2), ta, ty, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different fit"):
        ckpt.resumable_fit(dataclasses.replace(est, lam=0.5), ta, ty, checkpoint_dir=ck)
    moved = ta.clone()
    moved[0, 0] += 1.0  # same shape, other content
    with pytest.raises(ValueError, match="different fit"):
        ckpt.resumable_fit(est, moved, ty, checkpoint_dir=ck)
    # num_iter is not identity: a longer schedule continues the fit
    longer = dataclasses.replace(est, num_iter=6)
    resumed = ckpt.resumable_fit(longer, ta, ty, checkpoint_dir=ck, every=2)
    assert _models_rel(resumed, longer.fit(ta, ty)) <= TOL
    assert ckpt.read_step(ck)[1] == 6
    with pytest.raises(ValueError, match="every=0"):
        ckpt.resumable_fit(est, ta, ty, checkpoint_dir=ck, every=0)


def test_torn_newest_step_falls_back(tmp_path):
    a, y = _data(3)
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)
    est = BlockLeastSquaresEstimator(block_size=5, num_iter=4, lam=0.1)
    whole = ckpt.resumable_fit(
        dataclasses.replace(est, num_iter=5), ta, ty, checkpoint_dir=str(tmp_path / "w"), every=1)
    ck = tmp_path / "ck"
    ckpt.resumable_fit(est, ta, ty, checkpoint_dir=str(ck), every=1)
    # tear step 4's payload: its digest no longer matches
    blob = (ck / "step_4" / "leaves.pt").read_bytes()
    i = len(blob) // 2
    (ck / "step_4" / "leaves.pt").write_bytes(blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1:])
    before = metrics.get_registry().snapshot().get("ckpt_fallbacks", 0)
    resumed = ckpt.resumable_fit(
        dataclasses.replace(est, num_iter=5), ta, ty, checkpoint_dir=str(ck), every=1)
    assert metrics.get_registry().snapshot().get("ckpt_fallbacks", 0) == before + 1
    assert _models_equal(resumed, whole)
    # a removed sidecar record of leaf shapes is a torn step too
    rec = json.loads((ck / "digests_5.json").read_text())
    rec["leaves"] = rec["leaves"][:1]
    (ck / "digests_5.json").write_text(json.dumps(rec))
    with pytest.raises(ckpt.CheckpointCorruptError, match="torn"):
        ckpt.read_step(str(ck), 5)


def test_train_checkpointer_template_checks(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    w, m = torch.arange(6.0).reshape(2, 3), torch.zeros(3)
    saver = ckpt.TrainCheckpointer(ck, {"kind": "toy", "lr": 0.1})
    state, start = saver.restore({"w": w, "m": m, "count": torch.tensor(0)})
    assert start == 0
    rec = saver.save({"w": w * 2, "m": m + 1, "count": torch.tensor(3)}, 3)
    assert rec["bytes"] == 6 * 4 + 3 * 4 + 8 and len(rec["digests"]) == 3
    w2, m2, c2 = torch.zeros(2, 3), torch.zeros(3), torch.tensor(0)
    state = {"w": w2, "m": m2, "count": c2}
    got, start = ckpt.TrainCheckpointer(ck, {"kind": "toy", "lr": 0.1}).restore(state)
    assert start == 3 and got is state and torch.equal(w2, w * 2) and int(c2) == 3
    with pytest.raises(ValueError, match="different training run"):
        ckpt.TrainCheckpointer(ck, {"kind": "toy", "lr": 0.2}).restore(state)
    with pytest.raises(ckpt.CheckpointMismatchError, match="leaves"):
        ckpt.TrainCheckpointer(ck, {"kind": "toy", "lr": 0.1}).restore({"w": w2})
    with pytest.raises(ckpt.CheckpointMismatchError, match="shape or dtype"):
        ckpt.TrainCheckpointer(ck, {"kind": "toy", "lr": 0.1}).restore(
            {"w": torch.zeros(3, 2), "m": m2, "count": c2})
    # a key an older sidecar lacks compares as its legacy default
    legacy = ckpt.TrainCheckpointer(ck, {"kind": "toy", "lr": 0.1, "clip": 0.0},
                                    legacy_defaults={"clip": 0.0})
    assert legacy.restore(state)[1] == 3
    # more than one process needs the cluster layer's barrier
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        saver.save(state, 4)
