"""keystone_tpu_torch's mixture-of-experts layer and MoE LM against the JAX
package's: the layer's routing, capacity drops, groups and outputs (the
counterparts of tests/test_moe.py), then a MoE ``TransformerLM``'s
forward, prefill, teacher-forced decode, leaf gradients and 4 train steps
on leaves carried across with ``convert``, and the decode pool. Inputs
come from numpy seeds.

Routing is discontinuous: an f32 rounding apart can flip a token's top-2
when two experts' probabilities nearly tie. The tests compare the top-1
and top-2 indices first, on inputs whose top-1/top-2 and top-2/top-3
margins exceed ROUTE_MARGIN (checked, not assumed), and compare outputs
where the routing is equal. The tests scale the JAX layers' routers by
ROUTER_SCALE so that their inputs route with clear margins."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.models import lm_transformer as jlm  # noqa: E402
from keystone_tpu.models.lm.model import train_step_flops as j_flops  # noqa: E402
from keystone_tpu.models.lm.train import train as j_train  # noqa: E402
from keystone_tpu.ops.moe import MoELayer as JMoELayer  # noqa: E402
from keystone_tpu.serve.decode_loop import DecodeLoop as JDecodeLoop  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.models import lm  # noqa: E402
from keystone_tpu_torch.models.lm import decode  # noqa: E402
from keystone_tpu_torch.ops import moe  # noqa: E402
from keystone_tpu_torch.serve.decode_loop import DecodeLoop  # noqa: E402

F32_TOL = 1e-5
# bf16 expert products: one bf16 rounding of a sum taken in another order,
# relative to the output's largest entry
BF16_TOL = 1e-2
# tests/test_torch_lm.py's and tests/test_torch_lm_train.py's tolerances
DECODE_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
TRAIN_WEIGHT_ATOL = 2e-5
ROUTE_MARGIN = 1e-4
ROUTER_SCALE = 25.0
VOCAB, SEQ = 31, 16


def _jlayer(dim=16, ff=32, experts=4, cap=2.0, seed=0, **kw):
    """tests/test_moe.py's layer, its router scaled by ROUTER_SCALE."""
    jl = JMoELayer.create(jax.random.key(seed), dim, ff, experts, capacity_factor=cap, **kw)
    return dataclasses.replace(jl, w_router=jl.w_router * ROUTER_SCALE)


def _layer_leaves(jl) -> dict:
    return dict(w_router=jl.w_router, w1=jl.w1, w2=jl.w2,
                capacity_factor=jl.capacity_factor, group_size=jl.group_size)


def _port_layer(jl) -> moe.MoELayer:
    return convert.moe_layer(_layer_leaves(jl), device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _routes(x, w_router):
    """Top-1 and top-2 expert of every token of x (..., d), from f64
    logits, and the smallest top-1/top-2 and top-2/top-3 margin between
    the logits: the relative gap of the probabilities the router compares,
    which f32 rounding moves by about 1e-7."""
    logits = np.asarray(x, np.float64).reshape(-1, x.shape[-1]) @ np.asarray(w_router, np.float64)
    order = np.argsort(-logits, axis=-1, kind="stable")
    ls = np.take_along_axis(logits, order, axis=-1)
    gaps = ls[:, :-1] - ls[:, 1:]
    margin = gaps[:, :2].min() if logits.shape[1] > 2 else gaps[:, 0].min()
    return order[:, 0], order[:, 1], margin


def _port_routes(layer, x):
    """The port's own top-1 and top-2, as its router picks them."""
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, x.shape[-1]) @ layer.w_router, dim=-1)
    idx1 = torch.argmax(probs, dim=-1)
    idx2 = torch.argmax(probs * (1.0 - moe.one_hot(idx1, probs.shape[-1])), dim=-1)
    return idx1.numpy(), idx2.numpy()


def test_one_hot_gives_zero_rows_out_of_range():
    """jax.nn.one_hot's rule, which F.one_hot refuses on the CPU."""
    idx = torch.tensor([[0, 3, 4], [-1, 2, 7]])
    got = moe.one_hot(idx, 4)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx.numpy()), 4))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 2].sum() == 0 and got[1, 0].sum() == 0 and got[1, 2].sum() == 0
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(idx.clamp(min=0), 4)


def test_output_shape_and_aux_match_jax():
    jl = _jlayer()
    x = _x(0, (2, 8, 16))
    j1, j2, margin = _routes(x, jl.w_router)
    assert margin > ROUTE_MARGIN
    layer = _port_layer(jl)
    p1, p2 = _port_routes(layer, x)
    np.testing.assert_array_equal(p1, j1)
    np.testing.assert_array_equal(p2, j2)
    out, aux = layer(torch.from_numpy(x))
    j_out, j_aux = jl(jnp.asarray(x))
    assert out.shape == x.shape and aux.shape == () and aux.dtype == torch.float32
    assert torch.isfinite(out).all() and 0.5 < float(aux) < 16.0
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=F32_TOL)


def test_single_expert_matches_dense_ffn():
    """E = 1 with ample capacity routes every token to the one expert with
    gate 1: the plain tanh-GELU FFN."""
    layer = _port_layer(_jlayer(experts=1, cap=4.0))
    x = torch.from_numpy(_x(1, (2, 6, 16)))
    out, _ = layer(x)
    dense = torch.nn.functional.gelu(x @ layer.w1[0], approximate="tanh") @ layer.w2[0]
    torch.testing.assert_close(out, dense, rtol=0, atol=1e-5)


def test_gates_are_convex_and_starved_capacity_drops():
    """With ample capacity every token is kept and its two gates sum to 1;
    at the 1-slot floor some tokens drop, in both packages alike."""
    jl = _jlayer(experts=4, cap=4.0)
    layer = _port_layer(jl)
    x = _x(2, (1, 32, 16))
    out, _ = layer(torch.from_numpy(x))
    assert float(out.abs().sum()) > 0
    # the gates: probabilities of the two picks, renormalized
    probs = torch.softmax(torch.from_numpy(x[0]) @ layer.w_router, dim=-1)
    p1, p2 = _port_routes(layer, x)
    g1, g2 = probs[np.arange(32), p1], probs[np.arange(32), p2]
    s = g1 / (g1 + g2) + g2 / (g1 + g2)
    torch.testing.assert_close(s, torch.ones(32), rtol=0, atol=1e-6)
    starved = layer.replace(capacity_factor=0.0)
    j_starved = dataclasses.replace(jl, capacity_factor=0.0)
    out2, _ = starved(torch.from_numpy(x))
    assert float(out2.abs().sum()) < float(out.abs().sum())
    np.testing.assert_allclose(out2.numpy(), np.asarray(j_starved(jnp.asarray(x))[0]),
                               rtol=F32_TOL, atol=F32_TOL)


def test_capacity_drop_is_positionwise():
    """E = 1 at C = 1: the first token keeps its full expert output, every
    later token adds exactly zero (tests/test_moe.py:64)."""
    layer = _port_layer(_jlayer(experts=1, cap=8.0))
    x = torch.from_numpy(_x(3, (1, 8, 16)))
    full, _ = layer(x)
    starved, _ = layer.replace(capacity_factor=1e-9)(x)
    assert torch.all(starved[0, 1:] == 0.0)
    torch.testing.assert_close(starved[0, 0], full[0, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("s", [24, 21])
def test_grouped_routing_matches_single_group(s):
    """With no drops, groups of 8 (the last one padded when s = 21) equal
    one group: grouping bounds memory, not the result."""
    big = _port_layer(_jlayer(experts=4, cap=8.0))
    small = big.replace(group_size=8)
    x = torch.from_numpy(_x(4, (1, s, 16)))
    torch.testing.assert_close(small(x)[0], big(x)[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size,cap", [(4096, 1.25), (16, 1.25), (16, 0.5)])
def test_layer_matches_jax(dtype, group_size, cap):
    """The layer on moved leaves: the same routes, then the same output and
    aux, over one group and over several (the last padded), with and
    without drops."""
    jl = _jlayer(dim=32, ff=64, experts=8, cap=cap, seed=5, group_size=group_size)
    x = _x(6, (3, 15, 32))
    j1, j2, margin = _routes(x, jl.w_router)
    assert margin > ROUTE_MARGIN
    layer = _port_layer(jl)
    p1, p2 = _port_routes(layer, x)
    np.testing.assert_array_equal(p1, j1)
    np.testing.assert_array_equal(p2, j2)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out, aux = layer(torch.from_numpy(x).to(tdt))
    j_out, j_aux = jl(jnp.asarray(x, jdt))
    assert out.dtype == tdt and aux.dtype == torch.float32
    want = np.asarray(j_out, np.float32)
    got = out.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(float(aux), float(j_aux), rtol=F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
        np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-3)


# --- the MoE LM ----------------------------------------------------------


def _jmoe(depth=2, **kw):
    """tests/test_moe.py's MoE LM (block 1 dense, block 2 MoE), its router
    scaled by ROUTER_SCALE."""
    jm = jlm.TransformerLM.create(
        jax.random.key(0), vocab=VOCAB, max_seq=64, dim=32, depth=depth, num_heads=2,
        moe_every=2, num_experts=4, **kw,
    )
    return dataclasses.replace(jm, moe_layers=tuple(
        None if m is None else dataclasses.replace(m, w_router=m.w_router * ROUTER_SCALE)
        for m in jm.moe_layers
    ))


def moe_leaves(jm) -> dict:
    return {
        "embed": jm.embed,
        "pos_embed": jm.pos_embed,
        "blocks": [
            {n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
            for b in jm.blocks
        ],
        "moe_layers": [None if m is None else _layer_leaves(m) for m in jm.moe_layers],
    }


def port_moe(jm, **kw) -> lm.TransformerLM:
    return convert.transformer_lm(
        moe_leaves(jm), num_heads=jm.num_heads, pos_encoding=jm.pos_encoding,
        compute_dtype=jm.compute_dtype, moe_aux_weight=jm.moe_aux_weight, device="cpu", **kw,
    )


def _recorded_routes(pm, fn):
    """Run ``fn`` with every MoE layer of ``pm`` recording its input;
    returns the smallest routing margin over all of them."""
    seen = []
    handles = [m.register_forward_hook(lambda mod, args, out: seen.append((mod, args[0])))
               for m in pm.experts]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    assert seen
    return min(_routes(y.detach().to(torch.float32).numpy(), mod.w_router.detach())[2]
               for mod, y in seen)


def test_moe_lm_structure_matches_jax():
    jm = _jmoe()
    pm = port_moe(jm)
    assert pm.moe_layers[0] is None and pm.moe_layers[1] is not None
    assert tuple(pm.blocks[1].w1.shape) == (32, 0) and tuple(pm.blocks[1].w2.shape) == (0, 32)
    assert pm.num_params() == jm.num_params()
    assert [tuple(p.shape) for p in pm.leaves()] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jm)]
    for batch, seq in ((8, 128), (2, 16)):
        assert lm.train_step_flops(pm, batch, seq) == j_flops(jm, batch, seq)


def test_moe_lm_forward_matches_jax():
    jm = _jmoe()
    pm = port_moe(jm)
    toks = np.random.default_rng(0).integers(0, VOCAB, size=(2, 24))
    assert _recorded_routes(pm, lambda: pm(torch.from_numpy(toks))) > ROUTE_MARGIN
    logits, aux = pm.forward_with_aux(torch.from_numpy(toks))
    j_logits, j_aux = jax.jit(lambda m, t: m.forward_with_aux(t))(jm, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=F32_TOL, atol=F32_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=F32_TOL)


def test_moe_lm_bf16_forward_matches_jax():
    """bf16 compute: the logits within tests/test_torch_lm.py's bf16 bar."""
    jm = dataclasses.replace(_jmoe(), compute_dtype="bfloat16")
    pm = port_moe(jm)
    toks = np.random.default_rng(1).integers(0, VOCAB, size=(2, 24))
    got = pm(torch.from_numpy(toks))
    want = np.asarray(jax.jit(lambda m, t: m(t))(jm, jnp.asarray(toks)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0.12, atol=0.12)


@pytest.mark.parametrize("int8", [False, True])
def test_moe_prefill_and_decode_match_jax(int8):
    """Prefill, then teacher-forced decode steps: a (B, 1) step routes as
    one group of B tokens. With int8 weights the experts stay float."""
    jm = _jmoe()
    pm = port_moe(jm)
    if int8:
        jm = jlm.quantize_for_decode(jm)
        pm = lm.quantize_for_decode(pm)
        assert pm.moe_layers[1].w1.dtype == torch.float32
        assert tuple(pm.blocks[1].w1.shape) == (32, 0)
    toks = np.random.default_rng(9).integers(0, VOCAB, size=(3, 22))
    n_prompt, s_max = 12, 22

    def port_run():
        logits, cache = decode.prefill(pm, torch.from_numpy(toks[:, :n_prompt]), s_max)
        out = [logits]
        for j in range(s_max - n_prompt - 1):
            logits, cache = decode.decode_step(pm, torch.from_numpy(toks[:, n_prompt + j]), cache)
            out.append(logits)
        return out

    assert _recorded_routes(pm, port_run) > ROUTE_MARGIN
    got = port_run()
    jl, jc = jax.jit(jlm.prefill, static_argnums=2)(jm, jnp.asarray(toks[:, :n_prompt]), s_max)
    want = [jl]
    j_decode = jax.jit(jlm.decode_step)
    for j in range(s_max - n_prompt - 1):
        jl, jc = j_decode(jm, jnp.asarray(toks[:, n_prompt + j]), jc)
        want.append(jl)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"step {i}")


def test_moe_decode_pool_agrees_with_jax_pool():
    """The pooled step routes every slot, idle ones included, as one group,
    as the JAX package's pool does."""
    jm = _jmoe()
    pm = port_moe(jm)
    prompts = [[7, 3, 9], [11, 5, 2, 8, 4], [6, 1, 2]]
    want = JDecodeLoop(jm, slots=2, s_max=48, max_new=5).run(prompts, max_new=5)
    got = DecodeLoop(pm, slots=2, s_max=48, max_new=5).run(prompts, max_new=5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_moe_does_not_perturb_dense_seeding():
    """The port's create draws the experts after every dense weight: a MoE
    model's shared weights equal the dense model's, and the dense model's
    weights are those moe_every=0 always drew."""
    kw = dict(vocab=VOCAB, max_seq=32, dim=32, depth=4, num_heads=2, device="cpu")
    dense = lm.TransformerLM.create(generator=torch.Generator().manual_seed(7), **kw)
    again = lm.TransformerLM.create(generator=torch.Generator().manual_seed(7), moe_every=0, **kw)
    moe_m = lm.TransformerLM.create(generator=torch.Generator().manual_seed(7), moe_every=2,
                                    num_experts=4, capacity_factor=2.0, **kw)
    assert again.moe_layers == () and dense.num_params() == again.num_params()
    for a, b in zip(dense.leaves(), again.leaves()):
        assert torch.equal(a, b)
    assert torch.equal(dense.embed, moe_m.embed) and torch.equal(dense.pos_embed, moe_m.pos_embed)
    for i, (db, mb) in enumerate(zip(dense.blocks, moe_m.blocks)):
        for n in ("wq", "wk", "wv", "wo"):
            assert torch.equal(getattr(db, n), getattr(mb, n))
        if i % 2 == 0:
            assert torch.equal(db.w1, mb.w1) and torch.equal(db.w2, mb.w2)
        else:
            assert mb.w1.shape == (32, 0) and moe_m.moe_layers[i].capacity_factor == 2.0
    assert [m is None for m in moe_m.moe_layers] == [True, False, True, False]
    assert tuple(moe_m.moe_layers[1].w1.shape) == (4, 32, 128)


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_moe_leaf_gradients_match_jax(remat):
    """Every leaf's gradient of next_token_loss (with the weighted aux),
    and the loss, against jax.grad, with and without remat."""
    jm = _jmoe()
    if remat:
        jm = dataclasses.replace(jm, remat=True, remat_policy=remat)
    toks = np.random.default_rng(1).integers(0, VOCAB, size=(2, SEQ + 1))
    j_loss, j_grads = jax.value_and_grad(
        lambda m: jlm.next_token_loss(m, jnp.asarray(toks)))(jm)
    pm = port_moe(jm, remat=bool(remat), remat_policy=remat or "full")
    assert _recorded_routes(pm, lambda: pm(torch.from_numpy(toks[:, :-1]))) > ROUTE_MARGIN
    params = pm.leaves()
    for p in params:
        p.requires_grad_(True)
    loss = lm.next_token_loss(pm, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    j_grads = jax.tree_util.tree_leaves(j_grads)
    assert len(grads) == len(j_grads) == 2 + 6 * 2 + 3
    for i, (g, p, jg) in enumerate(zip(grads, params, j_grads)):
        g = np.zeros(p.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"leaf {i}")


def test_moe_train_matches_jax():
    """``train`` with MoE for 4 steps from the same leaves: the losses and
    the weights after the last step, at tests/test_torch_lm_train.py's
    tolerances."""
    kw = dict(steps=4, batch=4, seq=SEQ, lr=3e-3, seed=5)
    corpus = lm.synthetic_corpus(3000, VOCAB, seed=1)
    jm = _jmoe()
    pm = port_moe(jm)
    j_model, j_losses = j_train(jm, corpus, **kw)
    p_model, losses = lm.train(pm, corpus, **kw)
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    j_leaves = jax.tree_util.tree_leaves(j_model)
    assert len(p_model.leaves()) == len(j_leaves)
    for i, (p, jp) in enumerate(zip(p_model.leaves(), j_leaves)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0,
                                   atol=TRAIN_WEIGHT_ATOL, err_msg=f"leaf {i}")
