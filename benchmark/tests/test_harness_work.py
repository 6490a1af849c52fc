"""The work counts of ``benchmark/work`` against shapes worked by hand."""

from __future__ import annotations

import math

import pytest

from benchmark.harness import peaks
from benchmark.tests import tiny
from benchmark.work import fit, lm

MNIST = {"numFFTs": 32, "image_dim": 784, "num_classes": 10, "blockSize": 2048,
         "num_train": 60000, "solver_passes": 1, "gram_op": "int8",
         "solve_dtype": "float32", "featurize_dtype": "float32"}
GPT2M = {"n_embd": 1024, "n_layer": 24, "n_head": 16, "vocab_size": 50257,
         "n_positions": 1024, "n_inner": None, "ff_mult": 4}


def test_fit_counts():
    assert fit.next_pow2(784) == 1024
    assert fit.features(MNIST) == 32 * 512 == 16384
    assert fit.gram_ops(8192, 16384) == 8192 * 16384 * 16385
    assert fit.gram_bytes(8192, 16384) == 8192 * 16384 + 4 * 16384**2
    # per row and draw: 784 sign flips, 2.5 * 1024 * 10 FFT flops, 512 rectifies
    assert fit.featurize_flops(1, {"numFFTs": 1, "image_dim": 784}) == 784 + 25600 + 512
    assert fit.cross_flops(3, 4, 5) == 120
    # two blocks of 2 over 4 columns, one label: b³/3 + 2·b·D·K + 2·b²·K each
    assert fit.solve_flops(4, 1, 2) == pytest.approx(2 * (8 / 3 + 16 + 8))


def test_fit_stage_seconds_follow_the_dtypes():
    s = fit.fit_stage_seconds(MNIST, peaks)
    assert s["gram"] == pytest.approx(60000 * 16384 * 16385 / 1979e12)
    assert s["cross"] == pytest.approx(2 * 60000 * 16384 * 10 / 67e12)
    assert s["gram"] == pytest.approx(8.14e-3, rel=1e-2)


def test_bound_names_its_side():
    assert peaks.bound_s(1979e12, 0, "int8") == (pytest.approx(1.0), "operations")
    assert peaks.bound_s(0, 3.35e12, "bfloat16") == (pytest.approx(1.0), "bytes")


def test_lm_counts():
    assert lm.block_params(GPT2M) == 24 * (4 * 1024**2 + 2 * 1024 * 4096) == 301_989_888
    assert lm.params(GPT2M) == 301_989_888 + 50257 * 1024 + 1024 * 1024 == 354_501_632
    assert lm.train_step_flops(GPT2M, 16, 1024) == pytest.approx(
        6 * 354_501_632 * 16384 + 12 * 24 * 1024 * 1024**2 * 16)
    assert lm.prefill_flops(GPT2M, 100) == pytest.approx(
        2 * 301_989_888 * 100 + 24 * 2 * 1024 * 100 * 101 + 2 * 50257 * 1024)
    assert lm.decode_flops(GPT2M, 300) == pytest.approx(
        2 * 301_989_888 + 24 * 4 * 1024 * 300 + 2 * 50257 * 1024)
    ops, nbytes = lm.attention_call(GPT2M, 1, 256)
    assert ops == 16 * 2 * 64 * 256 * 257
    assert nbytes == 4 * 16 * 256 * 64 * 2
    ops, nbytes = lm.int8_matmul_call(32, 1024, 4096)
    assert ops == 2 * 32 * 1024 * 4096
    assert nbytes == 1024 * 4096 + 4 * 4096 + 2 * (32 * 1024 + 32 * 4096)


def test_train_step_flops_is_the_ports_formula():
    """The copy in ``work/lm.py`` gives what the port's own
    ``train_step_flops`` gives for the same dense model."""
    from keystone_tpu_torch.models.lm import TransformerLM, train_step_flops

    cfg = tiny.lm_config()
    model = TransformerLM.create(vocab=cfg["vocab_size"], max_seq=cfg["n_positions"],
                                 dim=cfg["n_embd"], depth=cfg["n_layer"],
                                 num_heads=cfg["n_head"], device="cpu")
    assert lm.train_step_flops(cfg, 4, 32) == pytest.approx(train_step_flops(model, 4, 32))
    assert lm.params(cfg) == model.num_params()


def test_causal_attention_ops_count_pairs():
    """``2 hd S (S + 1)`` a head: scores and the weighted sum, 2·hd flops
    each, over the S(S+1)/2 causal pairs."""
    cfg = {"n_embd": 8, "n_layer": 1, "n_head": 2, "vocab_size": 4, "n_positions": 8}
    s, hd = 5, 4
    pairs = s * (s + 1) // 2
    assert lm.attention_call(cfg, 1, s)[0] == 2 * (2 * hd * pairs * 2)
    assert math.isclose(lm.attention_call(cfg, 3, s)[0], 3 * lm.attention_call(cfg, 1, s)[0])


def _k4_trace(launches: int, ms_each: float = 0.01):
    from benchmark.harness.trace import DeviceTrace

    events = [{"cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 10**6}]
    events += [{"cat": "kernel", "name": "void int8_matmul_kernel<64>(int)", "ts": 10 * i,
                "dur": 1000 * ms_each} for i in range(launches)]
    return DeviceTrace(events)


@pytest.mark.parametrize("launches,expect", [
    (2 * 6, 100.0 * (1e-6 + 2e-6) / (12 * 1e-5)),  # the two narrowest sets
    (3 * 6, 100.0 * (1e-6 + 2e-6 + 5e-6) / (18 * 1e-5)),
    (13, 100.0 * (1e-6 + 2e-6) * 13 / 12 / (13 * 1e-5)),  # a record dropped or more
    (5 * 6, 100.0 * (1e-6 + 2e-6 + 5e-6) * 30 / 18 / (30 * 1e-5)),  # at most every set
    (0, None),
])
def test_k4_reader_learns_the_served_sets_from_launches(launches, expect):
    from benchmark.harness.cli import load_reader

    rec = {"trace": _k4_trace(launches), "spans": {}, "counters": {},
           "work": {"k4_calls": [(96, 5e-6), (32, 1e-6), (64, 2e-6)], "k4_launches_per_call": 6}}
    got = load_reader(tiny.ROOT, "k4.roofline_pct")(rec)
    assert got == (pytest.approx(expect) if expect is not None else None)


def test_decode_run_reports_the_token_gaps_tail():
    """The serving driver reports the tail of the gaps between a request's
    tokens beside the first token's."""
    out, _ = tiny.execute(tiny.decode_cell(), seconds=1.0)
    itl = out["metrics"]["itl_p95_ms"]["value"]
    assert out["metrics"]["itl_p95_ms"]["unit"] == "ms"
    assert 0 < itl < math.inf
    assert out["correct"], out["checks"]
