"""keystone_tpu_torch's continuous-batching decode pool: what it returns
equals the port's single-stream ``generate`` (greedy, f32), and agrees
with the JAX package's pool on the same weights."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from keystone_tpu.models.lm.model import TransformerLM as JTransformerLM  # noqa: E402
from keystone_tpu.serve.decode_loop import DecodeLoop as JDecodeLoop  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.models.lm import generate, quantize_for_decode  # noqa: E402
from keystone_tpu_torch.serve.decode_loop import DecodeLoop  # noqa: E402
from keystone_tpu_torch.serve.queue import ServeFuture  # noqa: E402

#: unequal-length prompts, as in tests/test_serve.py
PROMPTS = [[7, 3, 9], [11, 5, 2, 8, 4], [6, 1, 2]]


@pytest.fixture(scope="module")
def jax_lm():
    """tests/test_serve.py's decode model."""
    return JTransformerLM.create(
        jax.random.key(0), vocab=64, max_seq=96, dim=32, depth=2, num_heads=2
    )


@pytest.fixture(scope="module")
def lm(jax_lm):
    return convert.transformer_lm(
        {
            "embed": jax_lm.embed,
            "pos_embed": jax_lm.pos_embed,
            "blocks": [
                {n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                for b in jax_lm.blocks
            ],
        },
        num_heads=2,
        device="cpu",
    )


def _solo(lm, p, max_new: int = 5) -> np.ndarray:
    return generate(lm, torch.tensor([p]), max_new=max_new).numpy()[0]


def test_decode_loop_matches_single_stream_generate(lm):
    """Prompts joining and retiring mid-flight through the shared slot
    pool get exactly the tokens each gets decoded alone (greedy)."""
    loop = DecodeLoop(lm, slots=2, s_max=96, max_new=5)
    outs = loop.run(PROMPTS, max_new=5)
    assert len(outs) == len(PROMPTS)
    for p, got in zip(PROMPTS, outs):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, _solo(lm, p))
    assert loop.tokens_out == len(PROMPTS) * 5
    assert loop.occupancy_steps > 0 and not loop.pending()


def test_decode_loop_agrees_with_jax_pool(jax_lm, lm):
    want = JDecodeLoop(jax_lm, slots=2, s_max=96, max_new=5).run(PROMPTS, max_new=5)
    got = DecodeLoop(lm, slots=2, s_max=96, max_new=5).run(PROMPTS, max_new=5)
    agree = np.mean([np.mean(np.asarray(w) == g) for w, g in zip(want, got)])
    assert agree >= 0.9, agree


def test_decode_loop_eos_retires_early(lm):
    base = _solo(lm, [7, 3, 9], max_new=8)
    eos = int(base[3])
    loop = DecodeLoop(lm, slots=2, s_max=96, max_new=8, eos_id=eos)
    (out,) = loop.run([[7, 3, 9]], max_new=8)
    # retired at its first EOS: a prefix of the unbounded decode
    assert out[-1] == eos and len(out) <= 8
    np.testing.assert_array_equal(out, base[: len(out)])


def test_decode_loop_default_prefill_buckets_cover_s_max(lm):
    loop = DecodeLoop(lm, slots=1, s_max=96, max_new=8)
    assert loop.prefill_buckets[-1] >= 96
    assert all(
        any(w >= n for w in loop.prefill_buckets)
        for n in range(1, loop.max_prompt_len() + 1)
    )


def test_decode_loop_rejects_oversized_prompt(lm):
    loop = DecodeLoop(lm, slots=1, s_max=16, max_new=8)
    fut = loop.submit(np.arange(1, 12, dtype=np.int32))
    with pytest.raises(ValueError, match="s_max"):
        fut.result(0)
    with pytest.raises(ValueError, match="max_new"):
        loop.submit([1, 2], max_new=-1).result(0)
    with pytest.raises(ValueError, match="slots"):
        DecodeLoop(lm, slots=0)


def test_decode_loop_int8_kv_pool(lm):
    loop = DecodeLoop(quantize_for_decode(lm), slots=2, s_max=96, max_new=4, kv_dtype="int8")
    assert loop.cache.k.dtype == torch.int8
    outs = loop.run([[5, 6], [7, 8, 9]], max_new=4)
    assert [len(o) for o in outs] == [4, 4]
    assert all(((o >= 0) & (o < 64)).all() for o in outs)


def test_decode_loop_sampled_and_warm(lm):
    loop = DecodeLoop(lm, slots=3, s_max=40, max_new=6, temperature=1.0, top_k=10, seed=3)
    assert loop.warm() > 0
    assert not loop.pending()
    outs = loop.run(PROMPTS + [[1]], max_new=6)
    assert [len(o) for o in outs] == [6] * 4
    assert all(((o >= 0) & (o < 64)).all() for o in outs)


def test_decode_loop_worker_thread_drains(lm):
    loop = DecodeLoop(lm, slots=2, s_max=96, max_new=4)
    stop = threading.Event()
    t = threading.Thread(target=loop.worker, args=(stop, 0.01))
    t.start()
    futs = [loop.submit(p, max_new=4) for p in PROMPTS]
    stop.set()  # in-flight work drains before the worker exits
    t.join(timeout=60)
    assert not t.is_alive()
    for p, f in zip(PROMPTS, futs):
        np.testing.assert_array_equal(f.result(0), _solo(lm, p, 4))


def test_serve_future():
    f = ServeFuture()
    assert not f.done()
    with pytest.raises(TimeoutError):
        f.result(timeout=0)
    f.set_result(3)
    assert f.done() and f.result() == 3
    g = ServeFuture()
    g.set_exception(KeyError("x"))
    with pytest.raises(KeyError):
        g.result(0)
