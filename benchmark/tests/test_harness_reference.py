"""Each plain reference against the port's plain path at a tiny size on
the CPU, and the staged fit of the traced runs against ``fit_streaming``."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark.drivers import fit as fit_driver
from benchmark.harness import traffic, weights
from benchmark.reference import lm_train
from benchmark.reference import mnist_random_fft as ref_fit
from benchmark.reference import transformer_lm as ref_lm
from benchmark.tests import tiny


@pytest.fixture
def fp32_gram(monkeypatch):
    monkeypatch.setenv("KEYSTONE_GRAM_OP", "fp32")


def _fit_inputs(seed=7):
    cell = tiny.fit_cell()
    cfg = cell.config
    x, labels = traffic.mnist_rows(seed, cfg["num_train"], cfg["image_dim"], cfg["num_classes"], "cpu")
    signs = traffic.fft_signs(seed, cfg["numFFTs"], cfg["image_dim"])
    run = type("R", (), {"config": cfg, "device": "cpu"})()
    chain, y = fit_driver.build(run, x, labels, signs)
    return cfg, x, labels, signs, chain, y


def test_reference_features_are_the_ports(fp32_gram):
    cfg, x, labels, signs, chain, y = _fit_inputs()
    ours = torch.cat(chain.prefix(x[:64]), dim=-1)
    theirs = ref_fit.features(x[:64], signs)
    assert torch.allclose(ours.double(), theirs, rtol=1e-4, atol=1e-3 * theirs.abs().max().item())


def test_reference_fit_is_the_ports_fp32_fit(fp32_gram):
    """The port's streamed fit with the exact f32 Gram against the float64
    reference: the prediction gap is float32's, far under the int8
    reading."""
    from keystone_tpu_torch import plan as plan_mod

    cfg, x, labels, signs, chain, y = _fit_inputs()
    n = cfg["num_train"]
    fitted = plan_mod.fit_streaming(chain, x, y, n_valid=n, device=torch.device("cpu"))
    ref = ref_fit.fit(x, labels, signs, cfg, "cpu")
    err = ref_fit.prediction_errors(x, signs, ref, [fit_driver._model_of(fitted)], "cpu")[0]
    assert err < 5e-3


def test_staged_fit_equals_fit_streaming(monkeypatch):
    """The traced runs' three stages give ``fit_streaming``'s model, bit
    for bit, and one span each."""
    from keystone_tpu_torch import plan as plan_mod

    monkeypatch.setenv("KEYSTONE_GRAM_OP", "int8")
    cfg, x, labels, signs, chain, y = _fit_inputs()
    n = cfg["num_train"]
    dev = torch.device("cpu")
    whole = fit_driver._model_of(plan_mod.fit_streaming(chain, x, y, n_valid=n, device=dev))
    spans = {}
    fitted, plan = fit_driver.fit_in_stages(chain, x, y, n, dev, lambda: None,
                                            lambda k, s: spans.setdefault(k, []).append(s))
    assert plan.fit.fused and plan.fit.gram == "int8"
    staged = fit_driver._model_of(fitted)
    for a, b in zip(whole, staged):
        assert torch.equal(a, b)
    assert sorted(spans) == ["fit.plan", "fit.solve", "fit.stream"]


def _lm(cfg, leaves, dtype="float32"):
    return weights.build_model(leaves, cfg, dtype)


def test_reference_lm_is_the_ports_forward():
    cfg = tiny.lm_config()
    leaves = weights.lm_leaves(3, cfg, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, 40), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ours = _lm(cfg, leaves)(tokens)
        w = ref_lm.served_leaves(leaves, cfg, None)
        theirs = ref_lm.logits(w, cfg, ref_lm.hidden(w, cfg, tokens))
    assert torch.allclose(ours, theirs, atol=1e-4 * theirs.abs().max().item())


def test_reference_int8_weights_are_the_ports_served_weights():
    """The reference's own int8 rounding gives the port's served model:
    the port's ``quantize_for_decode`` computed in float32 against the
    reference over the dequantized weights."""
    from keystone_tpu_torch.models.lm import quantize_for_decode

    cfg = tiny.lm_config()
    leaves = weights.lm_leaves(4, cfg, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = quantize_for_decode(_lm(cfg, leaves))(tokens)
        w = ref_lm.served_leaves(leaves, cfg, 8)
        theirs = ref_lm.logits(w, cfg, ref_lm.hidden(w, cfg, tokens))
    assert torch.allclose(ours, theirs, atol=1e-4 * theirs.abs().max().item())


def test_served_gaps_of_the_reference_tokens_are_nought():
    cfg = tiny.lm_config()
    w = ref_lm.served_leaves(weights.lm_leaves(5, cfg, "cpu"), cfg, 8)
    prompt = [1, 2, 3, 4]
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(6):
            x = ref_lm.hidden(w, cfg, torch.tensor([seq]))
            seq.append(int(ref_lm.logits(w, cfg, x)[0, -1].argmax()))
    served = seq[len(prompt):]
    assert float(ref_lm.served_gaps(w, cfg, prompt, served).max()) == 0.0
    low = ref_lm.served_leaves(weights.lm_leaves(5, cfg, "cpu"), cfg, 4)
    assert float(ref_lm.served_gaps(w, cfg, prompt, served, control=low).max()) >= 0.0


def test_reference_training_is_the_ports_f32_step():
    """Three float32 steps of the port's train step against the
    reference's: losses, first gradients and changes within float32's
    rounding."""
    from keystone_tpu_torch.models.lm import make_optimizer, make_train_step

    cfg = tiny.lm_config()
    names = [n for n, _, _ in weights.shapes(cfg)]
    model = _lm(cfg, weights.lm_leaves(6, cfg, "cpu"))
    opt = make_optimizer(3e-4, weight_decay=0.01)
    step = make_train_step(opt)
    state = opt.init(model.leaves())
    batches = [traffic.token_batch(6, i, 4, 32, cfg["vocab_size"], "cpu") for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        model, state, loss = step(model, state, b)
        losses.append(float(loss))
        if i == 0:
            g1 = {n: float(m.norm()) / (1 - lm_train.B1) for n, m in zip(names, state.mu)}
    w0 = weights.lm_leaves(6, cfg, "cpu")
    delta = {n: float((w.detach() - w0[n]).norm()) for n, w in zip(names, model.leaves())}
    ref = lm_train.first_steps(w0, cfg, batches, 3e-4, 0.01, rows=2)
    assert max(abs(a - b) / b for a, b in zip(losses, ref["losses"])) < 1e-5
    assert lm_train.worst_leaf_gap(g1, ref["grad_norms"]) < 1e-4
    assert lm_train.worst_leaf_gap(delta, ref["delta_norms"]) < 1e-3


@pytest.mark.parametrize("make", [tiny.fit_cell, tiny.decode_cell, lambda: tiny.train_cell(
    {"loss_rel_gap": 1e-4, "grad_norm_gap": 4.5e-3, "update_norm_gap": 6e-4})])
def test_each_driver_judges_its_control_by_the_runs_check(make):
    """Every driver hands each compared number's control reading to the
    run's own judge, under the same names as the program's."""
    out, run = tiny.execute(make(), seconds=0.3, control=True)
    assert [n for n, *_ in run.control_checks] == [n for n, *_ in run.checks]
    assert run.control_correct in (True, False)


@pytest.mark.cuda
def test_controls_fail_at_the_cells_sizes():
    """On the card, at each cell's own size and on three seeds: the
    control (the reference in the next lower precision, in the program's
    place), judged by the run's own check against the cell's committed
    limits, comes out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json
    import subprocess
    import sys

    for cell in ("mnist_fit", "gpt2m_decode", "gpt2m_train", "gpt2m_prefill"):
        proc = subprocess.run(
            [sys.executable, os.path.join(tiny.ROOT, "benchmark", "tools", "readings.py"),
             "--workload", cell, "--seeds", "901,902,903", "--seconds", "3", "--control"],
            capture_output=True, text=True, timeout=3000, cwd=tiny.ROOT,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        for line in proc.stdout.strip().splitlines():
            read = json.loads(line)
            assert read["correct"], (cell, read)
            assert read["control_correct"] is False, (cell, read)
