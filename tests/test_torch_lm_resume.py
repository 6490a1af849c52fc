"""keystone_tpu_torch's LM training resume: a run preempted by the
``train.preempt`` fault and a run stopped by a real SIGTERM (the
``train.sigterm`` fault), each resumed from its checkpoint directory, give
the uninterrupted run's losses and weights bit for bit on the CPU; the
uninterrupted run's losses are held against the JAX package's ``train``
from the same leaves (carried across with ``convert.transformer_lm``) at
the LM train tests' 1e-5 relative bar; the run identity refuses another
run's directory and an over-trained checkpoint."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from keystone_tpu.models import lm_transformer as jlm  # noqa: E402
from keystone_tpu.models.lm.train import train as j_train  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from keystone_tpu_torch.models import lm  # noqa: E402
from keystone_tpu_torch.models.lm.train import train  # noqa: E402
from keystone_tpu_torch.resilience import faults  # noqa: E402

LOSS_RTOL = 1e-5
VOCAB, SEQ = 31, 16
KW = dict(steps=6, batch=4, seq=SEQ, lr=3e-3, seed=5, checkpoint_every=2)


def _jax_model():
    # a fresh one each time: the JAX train step donates its model's buffers
    return jlm.TransformerLM.create(
        jax.random.key(0), vocab=VOCAB, max_seq=2 * SEQ, dim=32, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def jax_model():
    jm = _jax_model()
    return {
        "embed": np.asarray(jm.embed),
        "pos_embed": np.asarray(jm.pos_embed),
        "blocks": [{n: np.asarray(getattr(b, n)) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                   for b in jm.blocks],
    }


def _port(leaves) -> lm.TransformerLM:
    return convert.transformer_lm(leaves, num_heads=4, device="cpu")


@pytest.fixture(scope="module")
def corpus():
    return lm.synthetic_corpus(3000, VOCAB, seed=1)


@pytest.fixture(scope="module")
def uninterrupted(jax_model, corpus, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("whole"))
    model, losses = train(_port(jax_model), corpus, **KW, checkpoint_dir=ck)
    return model, losses


def _weights_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


def test_uninterrupted_losses_match_jax(jax_model, corpus, uninterrupted):
    _, losses = uninterrupted
    kw = {k: v for k, v in KW.items() if k != "checkpoint_every"}
    _, j_losses = j_train(_jax_model(), corpus, **kw)
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("fault", ["train.preempt:@3:0", "train.sigterm:@2:0"])
def test_interrupted_run_resumes_bit_for_bit(jax_model, corpus, uninterrupted, tmp_path, fault):
    whole, whole_losses = uninterrupted
    ck = str(tmp_path / "ck")
    faults.configure(fault)
    try:
        if fault.startswith("train.preempt"):
            with pytest.raises(faults.SimulatedPreemption):
                train(_port(jax_model), corpus, **KW, checkpoint_dir=ck)
            done = 4  # the finally path saved the step the fault followed
        else:
            _, first = train(_port(jax_model), corpus, **KW, checkpoint_dir=ck)
            done = 3  # the signal stops the loop after the step in flight
            assert first == whole_losses[:done]
    finally:
        faults.reset()
    assert ckpt.read_step(ck)[1] == done
    resumed, losses = train(_port(jax_model), corpus, **KW, checkpoint_dir=ck)
    assert losses == whole_losses[done:]
    assert _weights_equal(resumed, whole)
    # a finished run on the directory has nothing left to do
    assert train(_port(jax_model), corpus, **KW, checkpoint_dir=ck)[1] == []


def test_run_identity_refuses_another_run(jax_model, corpus, tmp_path):
    ck = str(tmp_path / "ck")
    train(_port(jax_model), corpus, **{**KW, "steps": 2}, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different training run"):
        train(_port(jax_model), corpus, **{**KW, "steps": 2, "lr": 1e-3}, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="over-trained"):
        train(_port(jax_model), corpus, **{**KW, "steps": 1}, checkpoint_dir=ck)
