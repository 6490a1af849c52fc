"""keystone_tpu_torch's GPipe pipeline parallelism against the JAX
package's, on the CPU.

``parallel.pipeline_parallel.gpipe`` on a one-process mesh of eight CPU
positions against the JAX ``gpipe`` on the conftest's 8-device mesh, the
five cases of ``tests/test_pipeline_parallel.py`` (1e-5); the host
grouping that keeps a model axis within a host (stub hosts, against the
reference's ``_slice_groups`` on stub devices); and the LM's
pipeline-parallel forward and train steps (``tests/test_lm_transformer.py``
:315, :335, :373, :398, :449, :546, :666) against the JAX package's local
forward and step, at the reference tests' tolerances. The JAX models are
carried across with ``convert.transformer_lm``; inputs come from numpy
seeds.
"""

import dataclasses

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.models import lm_transformer as jlm  # noqa: E402
from keystone_tpu.parallel.mesh import _slice_groups  # noqa: E402
from keystone_tpu.parallel.mesh import create_mesh as j_create_mesh  # noqa: E402
from keystone_tpu.parallel.pipeline_parallel import gpipe as j_gpipe  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.models import lm  # noqa: E402
from keystone_tpu_torch.parallel import Mesh, create_mesh, gpipe  # noqa: E402
from keystone_tpu_torch.parallel.mesh import host_groups, mesh_order  # noqa: E402

CPU8 = ["cpu"] * 8


def _j_stage(params, act):
    return jnp.tanh(act @ params["w"] + params["b"])


def _t_stage(params, act):
    return torch.tanh(act @ params["w"] + params["b"])


def _stacked(rng, n_stages, d) -> dict:
    return {
        "w": rng.normal(scale=0.5, size=(n_stages, d, d)).astype(np.float32),
        "b": rng.normal(size=(n_stages, d)).astype(np.float32),
    }


def _both(params, x, **kw):
    """(port gpipe, JAX gpipe) of the same stages and input."""
    got = gpipe(_t_stage, {k: torch.from_numpy(v) for k, v in params.items()},
                torch.from_numpy(x), create_mesh(data=1, model=8, devices=CPU8),
                axis="model", **kw)
    want = j_gpipe(_j_stage, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                   j_create_mesh(data=1, model=8), axis="model", **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n_micro,bsz,d", [(4, 8, 16), (13, 4, 8)])
def test_gpipe_matches_jax(devices, n_micro, bsz, d):
    """(n_micro, B, d) microbatches, more microbatches than stages and not
    a multiple of them included."""
    rng = np.random.default_rng(n_micro)
    params = _stacked(rng, 8, d)
    x = rng.normal(size=(n_micro, bsz, d)).astype(np.float32)
    got, want = _both(params, x)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gpipe_flat_batch_matches_jax(devices):
    rng = np.random.default_rng(0)
    params = _stacked(rng, 8, 8)
    x = rng.normal(size=(24, 8)).astype(np.float32)
    got, want = _both(params, x, n_micro=4)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gpipe_validates_like_jax(devices):
    """The stage count on each leading axis, ``n_micro`` divisibility and
    the rank of the input under ``data_axis`` raise as the reference
    does."""
    rng = np.random.default_rng(1)
    mesh = create_mesh(data=2, model=4, devices=CPU8)
    three = {k: torch.from_numpy(v) for k, v in _stacked(rng, 3, 8).items()}
    with pytest.raises(ValueError, match="3 stages on its leading axis"):
        gpipe(_t_stage, three, torch.zeros(4, 2, 8), mesh, axis="model")
    four = {k: torch.from_numpy(v) for k, v in _stacked(rng, 4, 8).items()}
    with pytest.raises(ValueError, match="not divisible by n_micro=4"):
        gpipe(_t_stage, four, torch.zeros(10, 8), mesh, axis="model", n_micro=4)
    with pytest.raises(ValueError, match="batch dim to shard"):
        gpipe(_t_stage, four, torch.zeros(4), mesh, axis="model", data_axis="data")
    with pytest.raises(ValueError, match="not divisible by data axis"):
        gpipe(_t_stage, four, torch.zeros(4, 3, 8), mesh, axis="model", data_axis="data")


def test_gpipe_dp_gradients_match_sequential(devices):
    """dp × pp in one process: the output and the gradients of the input
    and of every stage's parameters equal the plain chain's."""
    rng = np.random.default_rng(2)
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in _stacked(rng, 4, 8).items()}
    x = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32)).requires_grad_()
    out = gpipe(_t_stage, params, x, create_mesh(data=2, model=4, devices=CPU8),
                axis="model", data_axis="data")
    ref = x
    for s in range(4):
        ref = _t_stage({k: v[s] for k, v in params.items()}, ref)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-6)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, [x, *params.values()], g)
    want = torch.autograd.grad(ref, [x, *params.values()], g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_mesh_host_grouping_single_and_multi(devices):
    """The reference groups devices by DCN slice; the port groups ranks by
    host and lays a model axis within a host. One host (or a layout no
    host can hold whole) keeps rank order; a 3-axis mesh keeps its
    names."""

    class FakeDev:
        def __init__(self, s):
            self.slice_index = s

    j_groups = _slice_groups([FakeDev(0), FakeDev(0), FakeDev(1), FakeDev(1)])
    groups = host_groups(["h0", "h0", "h1", "h1"])
    assert [len(v) for v in groups.values()] == [len(v) for v in j_groups.values()] == [2, 2]
    assert len(host_groups(["h"] * 8)) == len(_slice_groups(devices)) == 1
    # interleaved hosts: each model line of 2 is put on one host
    assert mesh_order(["a", "b", "a", "b"], 2) == [0, 2, 1, 3]
    assert mesh_order(["a", "b", "a", "b"], 1) == [0, 2, 1, 3]
    assert mesh_order(["a", "a", "a", "b"], 2) == [0, 1, 2, 3]
    assert mesh_order(["a"] * 4, 4) == [0, 1, 2, 3]
    assert create_mesh(data=4, model=2, devices=CPU8).shape == dict(
        j_create_mesh(data=4, model=2).shape)
    three = Mesh(np.array(CPU8, dtype=object).reshape(2, 2, 2), ("pipe", "data", "model"))
    assert three.shape == {"pipe": 2, "data": 2, "model": 2}
    assert three.axis_devices("pipe") == [torch.device("cpu")] * 2


# -- the LM's pipeline-parallel steps (tests/test_lm_transformer.py)


def _jax_model(seed, **kw):
    kw = {"vocab": 31, "max_seq": 32, "dim": 32, "depth": 4, "num_heads": 2, **kw}
    return jlm.TransformerLM.create(jax.random.key(seed), **kw)


def port_of(jm) -> lm.TransformerLM:
    leaves = {"embed": jm.embed, "pos_embed": jm.pos_embed,
              "blocks": [{n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                         for b in jm.blocks]}
    return convert.transformer_lm(
        leaves, num_heads=jm.num_heads, pos_encoding=jm.pos_encoding,
        compute_dtype=jm.compute_dtype, remat=jm.remat, remat_policy=jm.remat_policy,
        device="cpu")


def _toks(seed, batch, seq):
    return np.random.default_rng(seed).integers(0, 31, size=(batch, seq), dtype=np.int32)


@pytest.mark.parametrize("n_micro,batch,seq", [(4, 8, 32), (4, 4, 16)])
def test_pp_forward_matches_local(n_micro, batch, seq):
    """:315 and :398 (B == n_micro): the GPipe block chain against the JAX
    plain forward, within 2e-4."""
    jm = _jax_model(0, max_seq=seq)
    toks = _toks(0 if batch == 8 else 2, batch, seq)
    out = lm.pp_forward(port_of(jm), torch.from_numpy(toks),
                        create_mesh(data=2, model=4, devices=CPU8), n_micro=n_micro)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm(jnp.asarray(toks))),
                               atol=2e-4)


def _local_step(jm, toks):
    optimizer = optax.adamw(1e-3)
    m_ref, _, loss = jlm.make_train_step(optimizer)(jm, optimizer.init(jm), jnp.asarray(toks))
    return m_ref, float(loss)


def _check_pp_step(pm, step, jm_ref, j_loss, toks):
    optimizer = lm.make_optimizer(1e-3, weight_decay=1e-4)
    pm, _, loss = step(pm, optimizer.init(pm.leaves()), torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), j_loss, atol=1e-5)
    for a, b in zip(pm.leaves(), jax.tree_util.tree_leaves(jm_ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=5e-4)


PP_STEPS = {
    # name: (JAX model kwargs and seed, mesh axes, step kwargs)
    ":335 pp": ((1, {}), {"data": 2, "model": 4}, dict(n_micro=4)),
    ":449 dp x pp": ((1, {"depth": 2}), {"data": 4, "model": 2},
                     dict(n_micro=2, data_axis="data")),
    ":546 pp x dp x tp": ((2, {"depth": 2, "vocab": 32}), {"pipe": 2, "data": 2, "model": 2},
                          dict(n_micro=2, axis="pipe", data_axis="data")),
}


@pytest.mark.parametrize("case", list(PP_STEPS))
def test_pp_train_step_matches_local(case):
    """One pipeline-parallel train step (the reverse schedule from
    autograd) lands on the JAX local step's loss (1e-5) and parameters
    (5e-4); the 3-axis case runs the tensor-parallel layout over ``model``
    inside the stages."""
    (seed, kw), axes, step_kw = PP_STEPS[case]
    jm = _jax_model(seed, **kw)
    toks = _toks(1 if seed == 1 else 3, 8, 33)
    m_ref, j_loss = _local_step(jm, toks)
    grid = np.array(CPU8, dtype=object).reshape(*axes.values())
    mesh = Mesh(grid, tuple(axes))
    pm = port_of(_jax_model(seed, **kw))
    if "pipe" in axes:
        pm = lm.shard_params(pm, mesh)
        assert lm.sharding.leaf_specs(pm)[2] == (None, "model")
    step = lm.make_pp_train_step(lm.make_optimizer(1e-3, weight_decay=1e-4), mesh, **step_kw)
    _check_pp_step(pm, step, m_ref, j_loss, toks)


def test_pp_rejects_moe_and_ragged_depth_like_jax():
    """:373: dense blocks only, depth divisible by the stages, local
    attention only — the reference's checks and messages."""
    mesh = create_mesh(data=2, model=4, devices=CPU8)
    toks = torch.zeros((4, 8), dtype=torch.long)
    moe = port_of(_jax_model(0, max_seq=16))
    moe = moe.replace(moe_layers=tuple(
        lm.TransformerLM.create(vocab=31, max_seq=16, dim=32, depth=4, num_heads=2,
                                moe_every=2, num_experts=4, device="cpu").moe_layers))
    with pytest.raises(ValueError, match="dense blocks only"):
        lm.pp_forward(moe, toks, mesh, n_micro=2)
    shallow = port_of(_jax_model(0, max_seq=16, depth=3))
    with pytest.raises(ValueError, match="not divisible"):
        lm.pp_forward(shallow, toks, mesh, n_micro=2)
    ring = port_of(_jax_model(0, max_seq=16)).replace(seq_mode="ring", mesh=mesh)
    with pytest.raises(ValueError, match="seq_mode"):
        lm.pp_forward(ring, toks, mesh, n_micro=2)


def test_pp_composes_with_bf16_rope_remat():
    """:666: pp × dp under the bf16 policy, rope and remat against the JAX
    local forward, at the reference's bf16 tolerance (5e-2)."""
    jm = dataclasses.replace(
        _jax_model(3, compute_dtype="bfloat16", pos_encoding="rope"), remat=True)
    toks = _toks(3, 8, 32)
    out = lm.pp_forward(port_of(jm), torch.from_numpy(toks),
                        create_mesh(data=2, model=4, devices=CPU8), n_micro=4,
                        data_axis="data")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm(jnp.asarray(toks))),
                               atol=5e-2)
