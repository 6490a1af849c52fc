"""keystone_tpu_torch's ViT featurizer and ViT-ridge against the JAX
package's: patch extraction, the layer norm, the features on leaves
carried across with ``convert.vit_featurizer`` (dense attention, and the
ring over a 4-position CPU mesh), and ``vit_ridge.run`` on the same
featurizer. Images come from numpy seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.models import vit_ridge as j_vr  # noqa: E402
from keystone_tpu.ops import images as j_images  # noqa: E402
from keystone_tpu.ops import vit as j_vit  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.models import vit_ridge  # noqa: E402
from keystone_tpu_torch.ops import flash_attention, images, vit  # noqa: E402
from keystone_tpu_torch.parallel import create_mesh  # noqa: E402

# f32 features: the same arithmetic summed in another order, relative to
# max|f| (about 3)
FEAT_TOL = 1e-5
# the ridge fit's argmax on near-tied scores
ERR_TOL = 0.02


def vit_leaves(jv) -> dict:
    return {
        "patch_embed": jv.patch_embed,
        "pos_embed": jv.pos_embed,
        "blocks": [{n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                   for b in jv.blocks],
    }


def port_vit(jv, **kw) -> vit.ViTFeaturizer:
    return convert.vit_featurizer(vit_leaves(jv), patch_size=jv.patch_size,
                                  num_heads=jv.blocks[0].num_heads, device="cpu", **kw)


def _images(seed, n, size=32, c=3):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, size, size, c)).astype(np.float32)


@pytest.mark.parametrize("shape,k,stride", [((2, 32, 32, 3), 8, 8), ((3, 12, 10, 2), 3, 1),
                                            ((1, 17, 17, 3), 5, 3)])
def test_extract_patches_is_exact(shape, k, stride):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = images.extract_patches(torch.from_numpy(x), k, stride)
    want = np.asarray(j_images.extract_patches(jnp.asarray(x), k, stride))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # (dy, dx, c), channel fastest: patch (0, 0)'s second entry is pixel
    # (0, 0)'s second channel
    assert got[0, 0, 0, 1] == x[0, 0, 0, 1]


def test_layer_norm_matches_jax():
    x = np.random.default_rng(1).normal(3.0, 2.0, size=(4, 16, 128)).astype(np.float32)
    got = vit._layer_norm(torch.from_numpy(x))
    want = np.asarray(j_vit._layer_norm(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_create_matches_jax_shapes():
    jv = j_vit.ViTFeaturizer.create(jax.random.key(0))
    pv = vit.ViTFeaturizer.create(device="cpu")
    assert pv.patch_embed.shape == jv.patch_embed.shape == (192, 128)
    assert pv.pos_embed.shape == jv.pos_embed.shape == (16, 128)
    assert len(pv.blocks) == len(jv.blocks) == 4
    for pb, jb in zip(pv.blocks, jv.blocks):
        for n in ("wq", "wk", "wv", "wo", "w1", "w2"):
            assert tuple(getattr(pb, n).shape) == getattr(jb, n).shape
    assert pv(torch.from_numpy(_images(2, 3))).shape == (3, 128)


def test_features_match_jax():
    """Dense attention on the CPU (the K2 branch is the card's), as the JAX
    package's off-TPU default."""
    jv = j_vit.ViTFeaturizer.create(jax.random.key(0))
    x = _images(3, 8)
    before = flash_attention.FLASH_ATTENTION.launches
    got = port_vit(jv)(torch.from_numpy(x))
    assert flash_attention.FLASH_ATTENTION.launches == before
    want = np.asarray(jv(jnp.asarray(x)))
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEAT_TOL * np.abs(want).max())


def test_ring_branch_matches_dense():
    """A featurizer holding a mesh runs the ring: 16 patches over 4 CPU
    positions equal dense attention, and the JAX package's dense
    features."""
    jv = j_vit.ViTFeaturizer.create(jax.random.key(0))
    x = _images(4, 4)
    dense = port_vit(jv)(torch.from_numpy(x))
    ring = port_vit(jv, mesh=create_mesh(data=4, devices=["cpu"] * 4))(torch.from_numpy(x))
    tol = FEAT_TOL * float(dense.abs().max())
    torch.testing.assert_close(ring, dense, rtol=0, atol=tol)
    np.testing.assert_allclose(ring.numpy(), np.asarray(jv(jnp.asarray(x))), rtol=0, atol=tol)


def test_vit_ridge_run_matches_jax(monkeypatch):
    """``run`` at --synthetic 600 on the JAX package's featurizer, carried
    across: the same errors within ERR_TOL, and the reference's keys."""
    conf_kw = dict(synthetic=600)
    j_res = j_vr.run(j_vr.ViTRidgeConfig(**conf_kw))
    jv = j_vit.ViTFeaturizer.create(jax.random.key(0))
    monkeypatch.setattr(vit_ridge, "make_featurizer", lambda conf, size, device: port_vit(jv))
    res = vit_ridge.run(vit_ridge.ViTRidgeConfig(**conf_kw), device="cpu")
    assert res.keys() == j_res.keys()
    assert res["n_train"] == j_res["n_train"] == 600 and res["n_test"] == j_res["n_test"] == 120
    for key in ("train_error", "test_error"):
        assert abs(res[key] - j_res[key]) <= ERR_TOL, (key, res[key], j_res[key])
    assert res["train_error"] < 0.05
