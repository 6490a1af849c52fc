"""keystone_tpu_torch's held-out LM scoring against the JAX package's: a
sequence-parallel TransformerLM (ring, Ulysses) carried across with
``convert.transformer_lm``, its forward logits and ``evaluate_perplexity``
on the same tokens; the losses; the synthetic corpus; the byte-level text
loader. The JAX models run on 4 of its 8 virtual devices, the port's on a
4-position CPU mesh. Inputs come from numpy seeds."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.evaluation.perplexity import evaluate_perplexity as j_ppl  # noqa: E402
from keystone_tpu.loaders import text as jtext  # noqa: E402
from keystone_tpu.models import lm_transformer as jlm  # noqa: E402
from keystone_tpu.models.lm import losses as jlosses  # noqa: E402
from keystone_tpu.parallel import mesh as jmesh  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.evaluation import evaluate_perplexity  # noqa: E402
from keystone_tpu_torch.loaders import text  # noqa: E402
from keystone_tpu_torch.models import lm  # noqa: E402
from keystone_tpu_torch.models.lm import losses  # noqa: E402
from keystone_tpu_torch.ops import attention  # noqa: E402
from keystone_tpu_torch.parallel import create_mesh, use_mesh  # noqa: E402

FWD_TOL = 1e-5  # of max|logit|
LOSS_TOL = 1e-5  # relative
CE_TOL = 1e-6  # relative
N, SEQ, VOCAB = 4, 32, 64


def leaves(jm) -> dict:
    return {
        "embed": jm.embed,
        "pos_embed": jm.pos_embed,
        "blocks": [
            {n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
            for b in jm.blocks
        ],
    }


@pytest.fixture(scope="module")
def port_mesh():
    return create_mesh(data=N, devices=["cpu"] * N)


@pytest.fixture(scope="module")
def jax_model(devices):
    """vocab 64, dim 32, depth 2, 4 heads, rope; local attention."""
    return jlm.TransformerLM.create(
        jax.random.key(0), vocab=VOCAB, max_seq=SEQ, dim=32, depth=2, num_heads=4,
        pos_encoding="rope",
    )


def _port(jm, mesh, seq_mode):
    return convert.transformer_lm(
        leaves(jm), num_heads=jm.num_heads, pos_encoding=jm.pos_encoding,
        seq_mode=seq_mode, mesh=mesh, device="cpu",
    )


@pytest.fixture(scope="module")
def stream():
    """Five (SEQ+1)-token windows and a ragged tail."""
    return jlm.synthetic_corpus(5 * (SEQ + 1) + 7, VOCAB, seed=3)


@pytest.fixture(scope="module", params=["ring", "ulysses"])
def scored(request, jax_model, port_mesh, stream):
    """The JAX package's forward logits and losses for one seq_mode, and
    the port's model for it. The ring is scored on four windows (batch
    2, one compiled shape), Ulysses on all five (an uneven last batch)."""
    mode = request.param
    jm = dataclasses.replace(jax_model, seq_mode=mode, mesh=jmesh.create_mesh(data=N))
    toks = np.random.default_rng(4).integers(0, VOCAB, size=(2, SEQ))
    held = stream[: 4 * (SEQ + 1)] if mode == "ring" else stream
    want = {
        "logits": np.asarray(jax.jit(lambda m, t: m(t))(jm, jnp.asarray(toks))),
        "loss": j_ppl(jm, held, seq=SEQ, batch=2),
        "loss_chunked": j_ppl(jm, held, seq=SEQ, batch=2, logit_chunk=8),
    }
    return mode, _port(jax_model, port_mesh, mode), toks, held, want


def test_sequence_parallel_forward_matches_jax(scored):
    mode, pm, toks, _, want = scored
    assert pm.seq_mode == mode
    with torch.inference_mode():
        got = pm(torch.from_numpy(toks)).numpy()
    assert got.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(got, want["logits"], rtol=0,
                               atol=FWD_TOL * np.abs(want["logits"]).max())


@pytest.mark.parametrize("logit_chunk", [0, 8])
def test_evaluate_perplexity_matches_jax(scored, logit_chunk):
    _, pm, _, held, want = scored
    ref = want["loss_chunked" if logit_chunk else "loss"]
    got = evaluate_perplexity(pm, held, seq=SEQ, batch=2, logit_chunk=logit_chunk)
    assert got["tokens_scored"] == ref["tokens_scored"]
    for key in ("loss", "perplexity", "bits_per_token"):
        assert got[key] == pytest.approx(ref[key], rel=LOSS_TOL)


def test_ring_through_k3_plain_matches_plain_ring(monkeypatch, jax_model, port_mesh):
    """With the fused default forced on, the ring model's every live hop
    goes through flash_attention_step (K3's plain version on the CPU)."""
    pm = _port(jax_model, port_mesh, "ring")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, VOCAB, size=(2, SEQ)))
    with torch.inference_mode():
        plain = pm(toks)
        calls = []
        real = attention.flash_attention_step

        def counting(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(attention, "_flash_default", lambda x: True)
        monkeypatch.setattr(attention, "flash_attention_step", counting)
        fused = pm(toks)
    # depth 2; the LM is causal, so of the n² hops a layer the n(n+1)/2
    # whose block does not come from a later position
    assert len(calls) == 2 * N * (N + 1) // 2
    torch.testing.assert_close(fused, plain, rtol=0, atol=FWD_TOL * float(plain.abs().max()))


def test_sequence_parallel_modes_need_a_mesh_and_refuse_prefill(jax_model, port_mesh):
    with pytest.raises(ValueError, match="needs a mesh"):
        _port(jax_model, None, "ring")
    with use_mesh(port_mesh):
        assert _port(jax_model, None, "ulysses").mesh is port_mesh
    with pytest.raises(ValueError, match="seq_mode"):
        _port(jax_model, port_mesh, "tree")
    pm = _port(jax_model, port_mesh, "ring")
    assert pm.replace(seq_mode="local").mesh is port_mesh
    with pytest.raises(ValueError, match="seq_mode='local'"):
        lm.prefill(pm, torch.zeros((1, 4), dtype=torch.long), 8)


def test_local_next_token_loss_matches_jax(jax_model, stream):
    toks = stream[: 2 * (SEQ + 1)].reshape(2, SEQ + 1)
    pm = _port(jax_model, None, "local")
    for chunk in (0, 16):
        want = float(jlosses.next_token_loss(jax_model, jnp.asarray(toks), chunk))
        with torch.inference_mode():
            got = float(losses.next_token_loss(pm, torch.from_numpy(toks), chunk))
        assert got == pytest.approx(want, rel=LOSS_TOL)


def test_short_stream_raises_like_jax(jax_model):
    pm = _port(jax_model, None, "local")
    short = np.arange(SEQ, dtype=np.int32)
    with pytest.raises(ValueError, match="shorter than one window") as jerr:
        j_ppl(jax_model, short, seq=SEQ)
    with pytest.raises(ValueError, match="shorter than one window") as perr:
        evaluate_perplexity(pm, short, seq=SEQ)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("b,s,v", [(2, 12, 40), (3, 7, 257)])
def test_token_cross_entropy_matches_jax(b, s, v):
    rng = np.random.default_rng(b * s)
    logits = (4 * rng.normal(size=(b, s, v))).astype(np.float32)
    targets = rng.integers(0, v, size=(b, s))
    want = float(jlosses.token_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(losses.token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=CE_TOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_chunked_cross_entropy_matches_jax(compute_dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    embed = (0.3 * rng.normal(size=(VOCAB, 32))).astype(np.float32)
    targets = rng.integers(0, VOCAB, size=(2, 24))
    want = float(jlosses.chunked_token_cross_entropy(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(targets), jnp.dtype(compute_dtype), 8))
    cdt = getattr(torch, compute_dtype)
    got = losses.chunked_token_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(embed), torch.from_numpy(targets), cdt, 8)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=CE_TOL)
    with pytest.raises(ValueError, match="positive divisor"):
        losses.chunked_token_cross_entropy(
            torch.from_numpy(x), torch.from_numpy(embed), torch.from_numpy(targets), cdt, 5)


@pytest.mark.parametrize("n,vocab,seed", [(1000, 64, 0), (4 * 8193, 32768, 7)])
def test_synthetic_corpus_equals_jax(n, vocab, seed):
    got = lm.synthetic_corpus(n, vocab, seed=seed)
    want = jlm.synthetic_corpus(n, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_text_loader_matches_jax(tmp_path):
    d = tmp_path / "corp"
    d.mkdir()
    (d / "b.txt").write_bytes(b"the lazy dog. " * 20)
    (d / "a.txt").write_bytes(b"quick brown \xff\x00 fox " * 10)
    (d / "skip.bin").write_bytes(b"not text")
    assert text.BYTE_VOCAB == jtext.BYTE_VOCAB == 256
    assert np.array_equal(text.load_bytes(d), jtext.load_bytes(d))
    for frac in (0.1, 0.25):
        for got, want in zip(text.load_text_corpus(d, frac), jtext.load_text_corpus(d, frac)):
            assert got.dtype == want.dtype == np.int32
            assert np.array_equal(got, want)
    empty = tmp_path / "e.txt"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        text.load_bytes(empty)
    with pytest.raises(ValueError, match="valid_frac"):
        text.train_valid_split(np.arange(10), 1.0)
