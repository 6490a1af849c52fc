"""keystone_tpu_torch's tensor parallelism against the JAX package's, on the
CPU, in one process.

``shard_params``' layout against the JAX package's sharding specs (the
indivisible vocab and the heads that would straddle shards included); a
dp × tp ``train`` on a (4, 2) mesh of CPU positions against the JAX
package's unsharded ``train`` (2e-4, ``tests/test_lm_transformer.py:51``);
ring sequence parallelism composed with TP on one mesh (2e-4, ``:417``);
the vocab-sharded cross-entropy, dense and chunked, with every leaf's
gradient; an expert-parallel MoE step against the JAX package's sharded
MoE (its routers scaled by 25 and the routing gap asserted, as
``tests/test_torch_moe.py`` does); a TP model's checkpoint and resume, bit
for bit; a sharded model's decode against the whole model's, and the
refusal to shard an int8 model. The JAX models are
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
from keystone_tpu.parallel.mesh import create_mesh as j_create_mesh  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.core.checkpoint import read_step  # noqa: E402
from keystone_tpu_torch.models import lm  # noqa: E402
from keystone_tpu_torch.models.lm.sharding import leaf_specs  # noqa: E402
from keystone_tpu_torch.parallel import create_mesh  # noqa: E402

# tests/test_torch_lm_train.py's and tests/test_torch_moe.py's tolerances
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
ROUTER_SCALE, ROUTE_MARGIN = 25.0, 1e-4
CPU8 = ["cpu"] * 8


def _jax_model(seed=0, **kw):
    kw = {"vocab": 31, "max_seq": 64, "dim": 32, "depth": 2, "num_heads": 4, **kw}
    return jlm.TransformerLM.create(jax.random.key(seed), **kw)


def _layer_leaves(m) -> dict:
    return dict(w_router=m.w_router, w1=m.w1, w2=m.w2, capacity_factor=m.capacity_factor,
                group_size=m.group_size)


def port_of(jm, **kw) -> lm.TransformerLM:
    leaves = {"embed": jm.embed, "pos_embed": jm.pos_embed,
              "blocks": [{n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                         for b in jm.blocks],
              "moe_layers": [None if m is None else _layer_leaves(m) for m in jm.moe_layers]}
    return convert.transformer_lm(leaves, num_heads=jm.num_heads, num_kv_heads=jm.num_kv_heads,
                                  moe_aux_weight=jm.moe_aux_weight, device="cpu", **kw)


def _j_spec(leaf) -> tuple:
    spec = tuple(leaf.sharding.spec)
    return spec + (None,) * (leaf.ndim - len(spec))


def _toks(seed, batch, seq, vocab=31):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, seq), dtype=np.int32)


@pytest.mark.parametrize("kw,n_model", [
    (dict(vocab=32, moe_every=2, num_experts=4), 2),
    (dict(vocab=31, num_heads=4, num_kv_heads=2), 2),
    (dict(vocab=31), 4),
    (dict(vocab=32, num_heads=2), 4),
])
def test_shard_params_layout_matches_jax(devices, kw, n_model):
    """The split dim of every leaf against the JAX package's sharding
    spec: columns of wq/wk/wv/w1, rows of wo/w2 and of the embedding, MoE
    experts, the router and positions whole; a vocab of 31 over 4 stays
    whole in both. Where the heads would straddle shards (2 heads over 4)
    the port keeps the attention whole and the reference splits its
    columns; nothing else differs."""
    jm = _jax_model(**kw)
    j_mesh = j_create_mesh(data=8 // n_model, model=n_model)
    j_specs = [_j_spec(x) for x in jax.tree_util.tree_leaves(jlm.shard_params(jm, j_mesh))]
    pm = lm.shard_params(port_of(jm), create_mesh(data=8 // n_model, model=n_model,
                                                   devices=CPU8))
    specs = leaf_specs(pm)
    straddle = jm.num_heads % n_model or (jm.num_kv_heads or jm.num_heads) % n_model
    for i, (got, want) in enumerate(zip(specs, j_specs)):
        attn = 2 <= i < 2 + 6 * len(jm.blocks) and (i - 2) % 6 < 4
        if straddle and attn:
            assert got == (None, None), (i, got)
        else:
            assert got == want, (i, got, want)
    assert pm.tp.vocab == (kw["vocab"] % n_model == 0)


def test_dp_tp_train_matches_unsharded(devices):
    """:51: dp × tp ``train`` on a (4, 2) mesh against the JAX package's
    unsharded ``train`` on the same batches, losses and wq within 2e-4."""
    corpus = jlm.synthetic_corpus(5_000, 31, seed=2)
    jm, j_losses = jlm.train(_jax_model(), corpus, steps=3, batch=8, seq=32, seed=3)
    mesh = create_mesh(data=4, model=2, devices=CPU8)
    pm = lm.shard_params(port_of(_jax_model()), mesh)
    pm, losses = lm.train(pm, corpus, steps=3, batch=8, seq=32, seed=3, mesh=mesh)
    np.testing.assert_allclose(losses, j_losses, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(pm.blocks[0].wq.detach().numpy(), np.asarray(jm.blocks[0].wq),
                               rtol=2e-4, atol=2e-4)


def test_sp_tp_composed_on_one_mesh(devices):
    """:417: ring sequence parallelism over ``data`` with TP over
    ``model`` on one (4, 2) mesh: the forward against the JAX local model
    within 2e-4, and a composed train step against the JAX local step."""
    jm = _jax_model(dim=32, num_heads=8)
    mesh = create_mesh(data=4, model=2, devices=CPU8)
    comp = lm.shard_params(port_of(jm, seq_mode="ring", mesh=mesh), mesh)
    assert comp.tp.attn and comp.seq_mode == "ring"
    toks = _toks(0, 2, 64)
    np.testing.assert_allclose(comp(torch.from_numpy(toks)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(toks))), atol=2e-4)
    toks1 = _toks(1, 2, 65)
    optimizer = optax.adamw(1e-3)
    _, _, j_loss = jlm.make_train_step(optimizer)(jm, optimizer.init(jm), jnp.asarray(toks1))
    opt = lm.make_optimizer(1e-3, weight_decay=1e-4)
    _, _, loss = lm.make_train_step(opt)(comp, opt.init(comp.leaves()), torch.from_numpy(toks1))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=2e-4)


@pytest.mark.parametrize("chunk", [0, 16])
def test_vocab_sharded_cross_entropy_matches_jax(devices, chunk):
    """The CE over logits sharded four ways by vocab (the max and the two
    sums reduced over the model axis), dense and chunked: the loss and
    every leaf's gradient against ``jax.value_and_grad``."""
    jm = _jax_model(vocab=32)
    toks = _toks(5, 4, 33, vocab=32)
    j_loss, j_grads = jax.value_and_grad(
        lambda m: jlm.next_token_loss(m, jnp.asarray(toks), logit_chunk=chunk))(jm)
    pm = lm.shard_params(port_of(jm), create_mesh(data=2, model=4, devices=CPU8))
    assert pm.tp.vocab
    params = pm.leaves()
    for p in params:
        p.requires_grad_(True)
    loss = lm.next_token_loss(pm, torch.from_numpy(toks), logit_chunk=chunk)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    for g, p, jg in zip(grads, params, jax.tree_util.tree_leaves(j_grads)):
        got = np.zeros(p.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _routing_margin(pm, toks) -> float:
    """The smallest top-1/top-2 and top-2/top-3 router-logit gap over the
    MoE layers' inputs in a forward of ``pm`` (f64)."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append((mod, args[0])))
             for m in pm.experts]
    try:
        with torch.no_grad():
            pm(torch.from_numpy(toks))
    finally:
        for h in hooks:
            h.remove()
    margins = []
    for mod, y in seen:
        logits = (y.detach().double().reshape(-1, y.shape[-1]) @ mod.w_router.double()).numpy()
        ls = -np.sort(-logits, axis=-1)
        margins.append((ls[:, :-1] - ls[:, 1:])[:, :2].min())
    return min(margins)


def test_expert_parallel_moe_step_matches_jax(devices):
    """An expert-parallel MoE model (4 experts over 4 positions, router
    whole, each position running its experts on the whole router's
    dispatch): its loss and every leaf's gradient against the JAX
    package's sharded MoE model, the routers scaled by 25 so every gap is
    above 1e-4."""
    jm = _jax_model(vocab=32, num_heads=2, moe_every=2, num_experts=4)
    jm = dataclasses.replace(jm, moe_layers=tuple(
        None if m is None else dataclasses.replace(m, w_router=m.w_router * ROUTER_SCALE)
        for m in jm.moe_layers))
    toks = _toks(3, 4, 17, vocab=32)
    j_sharded = jlm.shard_params(jm, j_create_mesh(data=2, model=4))
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda m: jlm.next_token_loss(m, jnp.asarray(toks))))(j_sharded)
    pm = lm.shard_params(port_of(jm), create_mesh(data=2, model=4, devices=CPU8))
    assert pm.tp.experts and not pm.tp.attn
    assert _routing_margin(pm, toks[:, :-1]) > ROUTE_MARGIN
    params = pm.leaves()
    for p in params:
        p.requires_grad_(True)
    loss = lm.next_token_loss(pm, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    for g, p, jg in zip(grads, params, jax.tree_util.tree_leaves(j_grads)):
        got = np.zeros(p.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_tp_checkpoint_resumes_bit_for_bit(tmp_path):
    """A TP model's checkpoint holds the whole leaves, and a sharded run
    stopped after two steps and resumed to four lands on the
    uninterrupted sharded run's parameters bit for bit."""
    mesh = create_mesh(data=1, model=2, devices=["cpu"] * 2)
    corpus = jlm.synthetic_corpus(2_000, 31, seed=4)
    kw = dict(batch=4, seq=16, seed=1, checkpoint_every=1)
    whole, _ = lm.train(lm.shard_params(port_of(_jax_model()), mesh), corpus, steps=4, **kw)
    ck = str(tmp_path / "ck")
    lm.train(lm.shard_params(port_of(_jax_model()), mesh), corpus, steps=2, checkpoint_dir=ck,
             **kw)
    resumed, rest = lm.train(lm.shard_params(port_of(_jax_model()), mesh), corpus, steps=4,
                             checkpoint_dir=ck, **kw)
    assert len(rest) == 2
    saved, step = read_step(ck)
    assert step == 4
    for a, b, c in zip(whole.leaves(), resumed.leaves(), saved):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_sharded_model_refuses_decode():
    """A sharded model serves: its greedy ``generate`` equals the whole
    model's, and ``unshard_params`` gives back the whole model. What is
    refused is sharding an int8 model: ``shard_params`` of a quantized
    model raises ``ValueError``, as the JAX package's does."""
    mesh = create_mesh(data=1, model=2, devices=["cpu"] * 2)
    whole = port_of(_jax_model())
    pm = lm.shard_params(whole, mesh)
    prompt = np.array([[1, 2, 3], [4, 5, 6]])
    assert torch.equal(lm.generate(pm, prompt, max_new=6), lm.generate(whole, prompt, max_new=6))
    assert lm.unshard_params(pm).tp is None
    with pytest.raises(ValueError, match="quantize_for_decode"):
        lm.shard_params(lm.quantize_for_decode(whole), mesh)
