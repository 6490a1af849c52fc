"""keystone_tpu_torch int8 quantization and Gram (kernel K1's module)
against the JAX package.

The codes must equal JAX's exactly (ties included): both sides divide in
f32 and round half to even. The int8 Gram is held against the XLA int32
form exactly — like ``ata_int8_xla`` the port contracts a chunk's codes
exactly and rounds once to f32 — and against the interpret-mode Pallas
kernel at rtol 1e-5: that kernel sums 512-row partials in f32, so the two
differ in the last f32 bits of entries past 2²⁴.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.ops import gram as jg  # noqa: E402
from keystone_tpu.ops.quantization import symmetric_int8 as j_symmetric_int8  # noqa: E402
from keystone_tpu_torch.ops import gram as tg  # noqa: E402
from keystone_tpu_torch.ops.quantization import symmetric_int8  # noqa: E402

SHAPES = [(512, 256), (1024, 256), (300, 24), (1100, 130)]


def _rows(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(300, 24), (64, 7)])
def test_symmetric_int8_codes_equal_jax(shape):
    a = _rows(shape, 0) * 37.0
    jq, js = j_symmetric_int8(jnp.asarray(a), reduce_axes=(0,))
    q, s = symmetric_int8(torch.from_numpy(a), reduce_dims=(0,))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_symmetric_int8_half_way_ties_equal_jax():
    # a column with amax 127 has scale exactly 1.0, so x.5 values are
    # exact ties; round half to even sends 0.5→0, 1.5→2, 2.5→2, -0.5→-0
    col = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    a = np.stack([col, -col, col * 0.0], axis=1)
    jq, _ = j_symmetric_int8(jnp.asarray(a), reduce_axes=(0,))
    q, _ = symmetric_int8(torch.from_numpy(a), reduce_dims=(0,))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q[:, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_gram_matches_xla(shape):
    a = _rows(shape, 1)
    want = np.asarray(jg.ata_int8_xla(jnp.asarray(a)))
    got = tg.ata_int8(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_gram_matches_pallas_interpret(shape):
    a = _rows(shape, 2)
    want = np.asarray(jg.ata_int8_pallas(jnp.asarray(a), interpret=True))
    got = tg.ata_int8(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_ata_fp32_matches():
    a = _rows((300, 24), 5)
    want = np.asarray(jg.ata_fp32(jnp.asarray(a)))
    got = tg.ata_fp32(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,d", [(1537, 33), (512, 8), (5, 3), (0, 4), (131073, 3)])
def test_int8_gram_plain_is_exact_per_tile(n, d):
    """Each tile of rows — a segment of up to 131,072 rows — is exact and
    rounds once to f32; only the f32 sum of segments rounds again."""
    rng = np.random.default_rng(n + d)
    q = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    want = np.zeros((d, d), np.float32)
    for s in range(0, n, tg.SEGMENT_ROWS):
        t = q[s : s + tg.SEGMENT_ROWS].astype(np.int64)
        want += (t.T @ t).astype(np.float32)
    got = tg.int8_gram_plain(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    if n > tg.SEGMENT_ROWS:
        # a full segment's entries pass 2²⁴: rounding the segment and then
        # the sum of segments is not rounding the whole sum once
        exact = q.astype(np.int64).T @ q.astype(np.int64)
        assert (got != exact.astype(np.float32)).any()


@pytest.mark.parametrize("d", [1, 127, 300, 1000, 4096])
def test_gram_tiles_write_every_entry_once(d):
    """K1 writes entry (i, j) of a tile where i ≤ j and its mirror (j, i)
    where i < j: over its tile table every entry of the (d, d) result has
    exactly one writer, and no tile is computed twice."""
    tiles = tg.gram_tiles(d)
    assert len({tuple(t) for t in tiles.tolist()}) == len(tiles)
    writes = np.zeros((d, d), np.int64)
    for ti, tj in tiles.tolist():
        i = np.arange(ti * tg.TILE_I, min(d, (ti + 1) * tg.TILE_I))[:, None]
        j = np.arange(tj * tg.TILE_J, min(d, (tj + 1) * tg.TILE_J))[None, :]
        i, j = np.broadcast_arrays(i, j)
        np.add.at(writes, (i[i <= j], j[i <= j]), 1)
        np.add.at(writes, (j[i < j], i[i < j]), 1)
    assert (writes == 1).all()
    n_i, n_j = -(-d // 128), -(-d // 256)
    assert len(tiles) == sum(min(n_i, 2 * jj + 2) for jj in range(n_j))


def test_quantization_error_matches_jax():
    a = _rows((256, 40), 3)
    a[0] *= 50.0  # one heavy row
    for x in (a, np.maximum(a, 0), a - a.mean(axis=0)):
        assert tg.gram_quantization_error(torch.from_numpy(x)) == jg.gram_quantization_error(x)


def _gate_probe(seed):
    """A probe with what the gate must get right: zeros in many columns
    (so nonzero counts of both parities), an all-zero column, ties from
    coarse rounding, and one heavy-tailed column."""
    rng = np.random.default_rng(seed)
    n, d = int(rng.integers(1, 300)), int(rng.integers(1, 60))
    a = rng.normal(size=(n, d)).astype(np.float32)
    a[rng.random((n, d)) < rng.random()] = 0.0
    if seed % 2:
        a = np.round(a * 4) / 4  # ties: many equal magnitudes
    a[:, int(rng.integers(d))] = 0.0
    heavy = int(rng.integers(d))
    a[:, heavy] = rng.standard_cauchy(n).astype(np.float32)
    return a


@pytest.mark.parametrize("seed", range(24))
def test_quantization_gate_equals_jax_exactly(seed):
    a = _gate_probe(seed)
    assert tg.gram_quantization_error(torch.from_numpy(a)) == jg.gram_quantization_error(a)


@pytest.mark.parametrize(
    "col",
    [
        [0.0, 3.0, 1.0, 2.0],  # odd nonzero count
        [0.0, 0.0, 4.0, 1.0, 2.0, 3.0],  # even: the mean of the middle two
        [0.0, 0.0, 0.0, 0.0],  # all zero: skipped
        [1.0, 1.0, 1.0, 1.0, 5.0],  # ties around the median
        [3.4028235e38, 3.4028235e38, 0.0],  # the middle two's float32 sum overflows
        [1e-3, 1e-3, 1e-3, 1e4],  # heavy tail
    ],
)
def test_quantization_gate_column_cases(col):
    a = np.array([col, [-v for v in col]], np.float32).T
    assert tg.gram_quantization_error(a) == jg.gram_quantization_error(a)


def test_cpu_tensor_never_counts_a_launch():
    before = tg.INT8_GRAM.launches
    tg.ata_int8(torch.from_numpy(_rows((600, 20), 4)))
    tg.int8_gram(torch.zeros((10, 4), dtype=torch.int8))
    assert tg.INT8_GRAM.launches == before


def test_int8_gram_rejects_bad_input():
    with pytest.raises(TypeError):
        tg.int8_gram(torch.zeros((4, 4), dtype=torch.float32))
    with pytest.raises(TypeError):
        tg.int8_gram(torch.zeros((4,), dtype=torch.int8))


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("KEYSTONE_GRAM_OP", " INT8 ")
    assert tg.gram_op_request() == jg.gram_op_request() == "int8"
    monkeypatch.setenv("KEYSTONE_GRAM_OP", "bogus")
    assert tg.gram_op_request() == "auto"
    monkeypatch.setenv("KEYSTONE_GRAM_INT8_MAX_ERR", "0.07")
    assert tg.int8_error_threshold() == jg.int8_error_threshold() == 0.07
    monkeypatch.setenv("KEYSTONE_GRAM_INT8_MAX_ERR", "nan?")
    assert tg.int8_error_threshold() == 0.03
