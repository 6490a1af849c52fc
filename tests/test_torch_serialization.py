"""keystone_tpu_torch's fitted-pipeline persistence
(``core/serialization.py``): a fitted pipeline survives the round trip
bit for bit, and its outputs match the JAX package's pipeline with the
weights carried across through ``convert.py``; spec drift, garbage and a
truncated file are refused; a failed atomic write keeps the old file.

Tolerance: the port against the JAX package 1e-5 of max|out| (float32
products in another order); the round trip exactly."""

import dataclasses
import errno
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import linear as jl  # noqa: E402
from keystone_tpu.ops import stats as js  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.core import serialization as ser  # noqa: E402
from keystone_tpu_torch.core.pipeline import Pipeline, Transformer  # noqa: E402
from keystone_tpu_torch.ops.util import MaxClassifier  # noqa: E402
from keystone_tpu_torch.resilience import faults  # noqa: E402

TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture
def carried():
    """A JAX pipeline (scaler, linear map; a block mapper beside it) and
    the port's pipeline with the same weights."""
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(60, 12)) * 2 + 1).astype(np.float32)
    b = rng.normal(size=(60, 3)).astype(np.float32)
    scaler = js.StandardScaler().fit(jnp.asarray(a))
    lin = jl.LinearMapEstimator(lam=0.1).fit(scaler(jnp.asarray(a)), jnp.asarray(b))
    blk = jl.BlockLeastSquaresEstimator(block_size=5, num_iter=2, lam=0.2).fit(
        jnp.asarray(a), jnp.asarray(b))
    jax_pipe = scaler >> lin
    ours = Pipeline.of(
        convert._scaler(scaler.mean, scaler.std, "cpu"),
        convert.linear_mapper(lin.x, lin.b, device="cpu"),
    )
    ours_blk = convert.block_linear_mapper(blk.xs, blk.b, blk.means, block_size=5, device="cpu")
    return a, jax_pipe, blk, ours, ours_blk


def test_round_trip_matches_jax(tmp_path, carried):
    a, jax_pipe, jax_blk, ours, ours_blk = carried
    x = torch.from_numpy(a)
    for pipe, theirs in ((ours, jax_pipe), (Pipeline.of(ours_blk, MaxClassifier()), None)):
        path = str(tmp_path / "m.kst")
        spec = ser.save_fitted(pipe, path, corpus="synthetic-60", version=7)
        assert spec["leaves"] and all(leaf["dtype"] == "float32" for leaf in spec["leaves"])
        loaded, meta = ser.load_fitted(path, with_meta=True, device="cpu")
        assert meta == {"corpus": "synthetic-60", "version": 7}
        assert torch.equal(loaded(x), pipe(x))
        # load_pipeline takes the fitted format too, spec-checked
        assert torch.equal(ser.load_pipeline(path, device="cpu")(x), pipe(x))
        if theirs is not None:
            assert _rel(loaded(x).numpy(), np.asarray(theirs(jnp.asarray(a)))) <= TOL
    assert _rel(ours_blk(x).numpy(), np.asarray(jax_blk(jnp.asarray(a)))) <= TOL
    bare = str(tmp_path / "bare.kstp")
    ser.save_pipeline(ours_blk, bare)
    assert torch.equal(ser.load_pipeline(bare, device="cpu")(x), ours_blk(x))
    # bf16 leaves and a leaf shared by two places survive as such
    w = torch.randn(4, 4, dtype=torch.bfloat16)
    ser.save_pipeline({"a": w, "b": [w]}, bare)
    back = ser.load_pipeline(bare, device="cpu")
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], w)
    assert back["b"][0] is back["a"]
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


@dataclasses.dataclass(eq=False)
class Scale(Transformer):
    w: torch.Tensor
    name: str = "scale"

    def __call__(self, batch):
        return batch * self.w


def test_spec_drift_and_garbage_are_refused(tmp_path, monkeypatch):
    pipe = Pipeline.of(Scale(w=torch.ones(3)))
    path = str(tmp_path / "m.kst")
    ser.save_fitted(pipe, path)
    # a leaf's stored shape no longer matches what the load rebuilds
    with open(path, "rb") as f:
        f.read(len(ser._MAGIC_FITTED))
        payload = pickle.load(f)
    payload["spec"]["leaves"][0]["shape"] = [1, 2, 3]
    drifted = str(tmp_path / "drifted.kst")
    with open(drifted, "wb") as f:
        f.write(ser._MAGIC_FITTED)
        pickle.dump(payload, f)
    with pytest.raises(ser.PipelineSpecError, match="spec drift"):
        ser.load_fitted(drifted, device="cpu")
    assert issubclass(ser.PipelineSpecError, ValueError)

    # the node class gained a field since the save: the code drifted
    @dataclasses.dataclass(eq=False)
    class Scale2(Transformer):
        w: torch.Tensor
        name: str = "scale"
        bias: float = 0.0

    Scale2.__qualname__ = Scale2.__name__ = "Scale"
    monkeypatch.setattr(sys.modules[__name__], "Scale", Scale2)
    with pytest.raises(ser.PipelineSpecError, match="structure differs"):
        ser.load_fitted(path, device="cpu")

    junk = tmp_path / "junk.kst"
    junk.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a keystone_tpu_torch"):
        ser.load_fitted(str(junk), device="cpu")
    with pytest.raises(ValueError, match="not a keystone_tpu_torch"):
        ser.load_pipeline(str(junk), device="cpu")
    torn = tmp_path / "torn.kst"
    torn.write_bytes(open(drifted, "rb").read()[:40])
    with pytest.raises(ser.PipelineSpecError, match="unreadable"):
        ser.load_fitted(str(torn), device="cpu")


def test_atomic_write_failure_keeps_the_old_file(tmp_path):
    path = str(tmp_path / "artifact.bin")
    with ser.atomic_write(path) as f:
        f.write(b"old")
    with pytest.raises(RuntimeError, match="mid-write"):
        with ser.atomic_write(path) as f:
            f.write(b"new, half")
            raise RuntimeError("mid-write")
    assert open(path, "rb").read() == b"old"
    faults.configure("ckpt.disk_full:1.0:0")
    try:
        with pytest.raises(OSError) as e:
            with ser.atomic_write(path) as f:
                f.write(b"new")
        assert e.value.errno == errno.ENOSPC
    finally:
        faults.reset()
    assert open(path, "rb").read() == b"old"
    assert os.listdir(tmp_path) == ["artifact.bin"]
