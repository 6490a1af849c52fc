"""keystone_tpu_torch's data-parallel placement helpers
(parallel/mesh.py): padding to the data axis, chunk rounding and batch
placement, against the JAX package's on the conftest's virtual CPU
devices. Held exactly: these are shapes and copies."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.parallel import mesh as jmesh  # noqa: E402
from keystone_tpu_torch.parallel import mesh as tmesh  # noqa: E402


@pytest.mark.parametrize("n,multiple", [(10, 4), (12, 4), (0, 3), (1, 8), (7, 1)])
def test_pad_batch_matches_jax(n, multiple):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1.0
    jpad, jn = jmesh.pad_batch(x, multiple)
    npad, nn = tmesh.pad_batch(x, multiple)
    tpad, tn = tmesh.pad_batch(torch.from_numpy(x), multiple)
    assert jn == nn == tn == n
    np.testing.assert_array_equal(npad, np.asarray(jpad))
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    jt, _ = jmesh.pad_batch(jnp.asarray(x), multiple)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jt))


@pytest.mark.parametrize("data", [1, 2, 4])
def test_axis_size_and_chunk_rounding_match_jax(data):
    jm = jmesh.create_mesh(data=data, model=1, devices=jax.devices()[:data])
    tm = tmesh.create_mesh(data=data, devices=["cpu"] * data)
    assert tmesh.data_axis_size(tm) == jmesh.data_axis_size(jm) == data
    assert tmesh.data_axis_size(None) == jmesh.data_axis_size(None) == 1
    for chunk in (1, 7, 8, 8192, 8193):
        assert tmesh.shard_chunk_size(chunk, tm) == jmesh.shard_chunk_size(chunk, jm)


def test_shard_batch_pads_to_the_data_axis_and_places_rows():
    x = np.random.default_rng(0).normal(size=(10, 5)).astype(np.float32)
    jm = jmesh.create_mesh(data=4, model=1, devices=jax.devices()[:4])
    tm = tmesh.create_mesh(data=4, model=2, devices=["cpu"] * 8)
    got = tmesh.shard_batch(x, tm)
    want = jmesh.shard_batch(x, jm)
    assert got.device.type == "cpu" and got.shape == (12, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tmesh.shard_batch(x, tm, pad=False).shape == (10, 5)
    assert tmesh.data_sharding(tm, 3) == torch.device("cpu")
    assert tmesh.data_sharding(None) is None
    # without a mesh: the rows as they are, on the asked device, or the
    # ambient mesh's placement
    plain = tmesh.shard_batch(x, device="cpu")
    assert plain.shape == (10, 5) and torch.equal(plain, torch.from_numpy(x))
    with tmesh.use_mesh(tm):
        assert tmesh.shard_batch(x).shape == (12, 5)
        assert tmesh.data_sharding() == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.shard_batch(x)
