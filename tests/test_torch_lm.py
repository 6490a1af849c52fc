"""keystone_tpu_torch's LM serving path against the JAX package's: the
JAX tiny models carried across with ``convert.transformer_lm``, then the
forward, prefill and teacher-forced decode, greedy generation and the
sampling filter compared on the same tokens (numpy seeds)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.models import lm_transformer as jlm  # noqa: E402
from keystone_tpu.models.lm.decode import _filter_logits as j_filter  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.models import lm  # noqa: E402
from keystone_tpu_torch.models.lm import decode, model as lm_model  # noqa: E402
from keystone_tpu_torch.ops import flash_attention, int8_matmul  # noqa: E402

FWD_TOL = 1e-5
DECODE_TOL = 1e-4


def leaves(jm) -> dict:
    return {
        "embed": jm.embed,
        "pos_embed": jm.pos_embed,
        "blocks": [
            {n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
            for b in jm.blocks
        ],
    }


def j_forward(jm, toks):
    return np.asarray(jax.jit(lambda m, t: m(t))(jm, jnp.asarray(toks)))


def port_of(jm) -> lm.TransformerLM:
    return convert.transformer_lm(
        leaves(jm), num_heads=jm.num_heads, num_kv_heads=jm.num_kv_heads,
        pos_encoding=jm.pos_encoding, compute_dtype=jm.compute_dtype,
        int8_kernel=jm.int8_kernel, device="cpu",
    )


@pytest.fixture(scope="module")
def tiny():
    """tests/test_lm_transformer.py's tiny model."""
    return jlm.TransformerLM.create(
        jax.random.key(0), vocab=31, max_seq=64, dim=64, depth=2, num_heads=4
    )


@pytest.fixture(scope="module")
def tiny_int8():
    """tests/test_int8_matmul.py's decode model, weight-only int8."""
    jm = jlm.TransformerLM.create(
        jax.random.key(0), vocab=64, max_seq=48, dim=32, depth=2, num_heads=4
    )
    return jlm.quantize_for_decode(jm)


def test_forward_logits_match_jax(tiny):
    toks = np.random.default_rng(0).integers(0, 31, size=(2, 24))
    got = port_of(tiny)(torch.from_numpy(toks))
    want = j_forward(tiny, toks)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 31)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_num_params_and_quantized_leaves_match_jax(tiny, tiny_int8):
    assert port_of(tiny).num_params() == tiny.num_params()
    assert port_of(tiny_int8).num_params() == tiny_int8.num_params()
    assert not lm_model.has_quantized_leaves(port_of(tiny))
    assert lm_model.has_quantized_leaves(port_of(tiny_int8))


def _teacher_forced(jm, pm, toks, n_prompt, kv_dtype=None, lens=None):
    """Prefill then decode_step along ``toks`` in both packages; every
    step's logits agree within DECODE_TOL."""
    prompt = toks[:, :n_prompt]
    s_max = toks.shape[1]
    # jitted here, so the JAX side reads KST_LOCAL_ATTN when this traces
    j_decode = jax.jit(jlm.decode_step)
    j_prefill = jax.jit(jlm.prefill, static_argnums=2, static_argnames="kv_dtype")
    jl, jc = j_prefill(
        jm, jnp.asarray(prompt), s_max, kv_dtype=kv_dtype,
        lengths=None if lens is None else jnp.asarray(lens, jnp.int32),
    )
    pl, pc = decode.prefill(
        pm, torch.from_numpy(prompt), s_max, kv_dtype=kv_dtype,
        lengths=None if lens is None else torch.tensor(lens),
    )
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=DECODE_TOL, atol=DECODE_TOL)
    start = np.asarray(lens if lens is not None else [n_prompt] * toks.shape[0])
    for j in range(s_max - n_prompt - 1):
        # each row feeds its own next token: toks[row, start + j]
        tok = toks[np.arange(toks.shape[0]), start + j]
        jl, jc = j_decode(jm, jnp.asarray(tok), jc)
        pl, pc = decode.decode_step(pm, torch.from_numpy(tok), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=DECODE_TOL, atol=DECODE_TOL)


def test_prefill_and_decode_match_jax_float(tiny):
    toks = np.random.default_rng(9).integers(0, 31, size=(3, 22))
    _teacher_forced(tiny, port_of(tiny), toks, 12)


def test_decode_matches_full_forward(tiny):
    """The port's own teacher-forced decode equals its full forward (the
    JAX package's test_kv_cache_decode_matches_full_forward_logits)."""
    pm = port_of(tiny)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 31, size=(3, 22)))
    full = pm(toks)
    logits, cache = decode.prefill(pm, toks[:, :12], 22)
    torch.testing.assert_close(logits, full[:, 11], rtol=0, atol=DECODE_TOL)
    for j in range(9):
        logits, cache = decode.decode_step(pm, toks[:, 12 + j], cache)
        torch.testing.assert_close(logits, full[:, 12 + j], rtol=0, atol=DECODE_TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_and_decode_match_jax_int8_weights(tiny_int8, kv_dtype):
    toks = np.random.default_rng(3).integers(0, 64, size=(2, 20))
    _teacher_forced(tiny_int8, port_of(tiny_int8), toks, 8, kv_dtype=kv_dtype)


def test_prefill_and_decode_match_jax_gqa_rope():
    jm = jlm.TransformerLM.create(
        jax.random.key(1), vocab=40, max_seq=32, dim=32, depth=2, num_heads=4,
        num_kv_heads=2, pos_encoding="rope",
    )
    pm = port_of(jm)
    assert pm.kv_heads == 2 and pm.pos_encoding == "rope"
    toks = np.random.default_rng(4).integers(0, 40, size=(2, 18))
    _teacher_forced(jm, pm, toks, 7, kv_dtype="int8")
    np.testing.assert_allclose(
        pm(torch.from_numpy(toks)).numpy(), j_forward(jm, toks),
        rtol=FWD_TOL, atol=FWD_TOL,
    )


def test_per_row_prompt_lens_match_jax(tiny):
    """Right-padded prompts of unequal length: per-row cache positions."""
    toks = np.random.default_rng(5).integers(0, 31, size=(3, 20))
    _teacher_forced(tiny, port_of(tiny), toks, 9, lens=[9, 5, 7])


def test_flash_and_kernel_routes_match_jax(tiny_int8, monkeypatch):
    """KST_LOCAL_ATTN=flash on both sides (the port's plain K2, the JAX
    Pallas kernel in interpret mode) and int8_kernel kernel/pallas on
    both sides (the port's plain K4, the JAX kernel in interpret mode)."""
    monkeypatch.setenv("KST_LOCAL_ATTN", "flash")
    jm = dataclasses.replace(tiny_int8, int8_kernel="pallas")
    pm = port_of(jm)
    assert pm.int8_kernel == "kernel"
    k2, k4 = flash_attention.FLASH_ATTENTION.launches, int8_matmul.INT8_MATMUL.launches
    toks = np.random.default_rng(6).integers(0, 64, size=(2, 14))
    _teacher_forced(jm, pm, toks, 8)
    # on the CPU both wrappers take their plain versions: no launch
    assert flash_attention.FLASH_ATTENTION.launches == k2
    assert int8_matmul.INT8_MATMUL.launches == k4


def test_greedy_generate_agrees_with_jax(tiny_int8):
    """test_int8_matmul.py's bar: ≥ 0.9 of greedy tokens agree."""
    prompt = np.random.default_rng(42).integers(0, 64, size=(2, 8))
    want = np.asarray(jlm.generate(tiny_int8, jnp.asarray(prompt), max_new=8, kv_dtype="int8"))
    pm = port_of(tiny_int8)
    for kernel in ("mm", "kernel"):
        got = lm.generate(pm.replace(int8_kernel=kernel), torch.from_numpy(prompt),
                          max_new=8, kv_dtype="int8")
        assert got.dtype == torch.int32 and got.shape == (2, 8)
        assert (got.numpy() == want).mean() >= 0.9


def test_generate_prompt_lens_and_eos_match_jax(tiny):
    pm = port_of(tiny)
    prompt = np.random.default_rng(8).integers(0, 31, size=(2, 6))
    lens = np.array([6, 3])
    want = np.asarray(jlm.generate(tiny, jnp.asarray(prompt), max_new=7,
                                   prompt_lens=jnp.asarray(lens, jnp.int32)))
    got = lm.generate(pm, prompt, max_new=7, prompt_lens=lens).numpy()
    assert (got == want).mean() >= 0.9
    eos = int(got[0, 2])
    out = lm.generate(pm, prompt, max_new=7, prompt_lens=lens, eos_id=eos).numpy()
    k = int(np.argmax(out[0] == eos))
    np.testing.assert_array_equal(out[0, : k + 1], got[0, : k + 1])
    assert (out[0, k:] == eos).all()


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.7), (7, 0.5), (31, 0.99)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(top_k).normal(size=(4, 31)).astype(np.float32) * 3
    got = decode._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    want = np.asarray(j_filter(jnp.asarray(logits), top_k, top_p))
    np.testing.assert_array_equal(got, want)


def test_filter_logits_rejects_bad_top_k():
    with pytest.raises(ValueError, match="top_k"):
        decode._filter_logits(torch.zeros(2, 5), 6, 0.0)


def test_sampled_generate_stays_in_vocab(tiny):
    pm = port_of(tiny)
    prompt = np.random.default_rng(3).integers(0, 31, size=(2, 8))
    gen = torch.Generator().manual_seed(5)
    toks = lm.generate(pm, prompt, max_new=6, temperature=1.0, top_k=8, top_p=0.9, generator=gen)
    assert toks.shape == (2, 6) and ((toks >= 0) & (toks < 31)).all()
    with pytest.raises(ValueError, match="max_seq"):
        lm.generate(pm, prompt, max_new=1000)


def test_decode_past_capacity_poisons_logits(tiny):
    pm = port_of(tiny)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 31, size=(2, 4)))
    _, cache = decode.prefill(pm, prompt, 5)
    logits, cache = decode.decode_step(pm, prompt[:, 0], cache)  # pos 4: last slot
    assert torch.isfinite(logits).all()
    logits, _ = decode.decode_step(pm, prompt[:, 0], cache)  # pos 5: past the end
    assert torch.isnan(logits).all()
    _, vc = decode.prefill(pm, prompt, 5, lengths=[4, 2])
    vc = dataclasses.replace(vc, pos=torch.tensor([5, 2]))
    logits, _ = decode.decode_step(pm, prompt[:, 0], vc)
    assert torch.isnan(logits[0]).all() and torch.isfinite(logits[1]).all()


def test_bf16_compute_tracks_f32(tiny):
    """The JAX package's bf16 policy bar: f32 logits, within 0.12 of the
    f32 forward."""
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 31, size=(4, 32)))
    pm = port_of(tiny)
    lo32, lo16 = pm(toks), pm.replace(compute_dtype="bfloat16")(toks)
    assert lo16.dtype == torch.float32
    torch.testing.assert_close(lo16, lo32, rtol=0.12, atol=0.12)


def test_unknown_options_raise(tiny, monkeypatch):
    pm = port_of(tiny)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="int8_kernel"):
        decode.prefill(pm.replace(int8_kernel="nope"), toks, 8)
    with pytest.raises(ValueError, match="int8_kernel"):
        convert.transformer_lm(leaves(tiny), num_heads=4, int8_kernel="nope")
    with pytest.raises(ValueError, match="needs a mesh"):
        pm.replace(seq_mode="ring")
    with pytest.raises(ValueError, match="seq_mode"):
        pm.replace(seq_mode="tree")
    # a MoE model is made, with the JAX package's structure: the same leaf
    # shapes in the same order and the same parameter count
    pmoe = lm.TransformerLM.create(moe_every=2, device="cpu")
    jmoe = jlm.TransformerLM.create(jax.random.key(0), moe_every=2)
    assert [tuple(p.shape) for p in pmoe.leaves()] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jmoe)]
    assert pmoe.num_params() == jmoe.num_params()
    with pytest.raises(ValueError, match="remat_policy"):
        pm.replace(remat=True, remat_policy="nope")(toks)
    monkeypatch.setenv("KST_LOCAL_ATTN", "bogus")
    with pytest.raises(ValueError, match="KST_LOCAL_ATTN"):
        pm(toks)


def test_create_on_cpu_and_quantize_for_decode():
    gen = torch.Generator().manual_seed(3)
    pm = lm.TransformerLM.create(vocab=50, max_seq=16, dim=32, depth=2, num_heads=4,
                                 num_kv_heads=2, device="cpu", generator=gen)
    assert pm.device.type == "cpu" and pm.blocks[0].wk.shape == (32, 16)
    qm = lm.quantize_for_decode(pm)
    assert qm.embed.scale.shape == (50, 1) and qm.blocks[0].w1.scale.shape == (1, 128)
    assert torch.equal(qm.pos_embed, pm.pos_embed)
    w = pm.blocks[0].w1.detach().numpy()
    from keystone_tpu.ops.quantization import quantize_int8

    # the recipe is shared: the codes equal the JAX package's
    np.testing.assert_array_equal(qm.blocks[0].w1.q.numpy(), np.asarray(quantize_int8(jnp.asarray(w)).q))
