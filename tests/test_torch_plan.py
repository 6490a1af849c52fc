"""The port's planner (keystone_tpu_torch.plan) on the CPU: the fused
streaming fit's plan for the MNIST chain against the JAX package's plan on
the same rows and the same random signs, and the sampled cost pass's
handling of nodes the probe cannot run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu import plan as jplan  # noqa: E402
from keystone_tpu.core.pipeline import ChainedLabelEstimator as JChained  # noqa: E402
from keystone_tpu.models import mnist_random_fft as jm  # noqa: E402
from keystone_tpu.ops.linear import BlockLeastSquaresEstimator as JBLS  # noqa: E402
from keystone_tpu.ops.util import ClassLabelIndicators as JCLI  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch import plan as tplan  # noqa: E402
from keystone_tpu_torch.core.pipeline import (  # noqa: E402
    ChainedLabelEstimator,
    Pipeline,
    transformer,
)
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator  # noqa: E402
from keystone_tpu_torch.ops.util import ClassLabelIndicators  # noqa: E402
from keystone_tpu_torch.plan import costs  # noqa: E402
from keystone_tpu_torch.plan.ir import chain_from  # noqa: E402

CPU = torch.device("cpu")
N, NUM_FFTS, BLOCK, CHUNK = 1200, 2, 512, 256


def _fit_operator(decisions):
    return next(d for d in decisions if d["action"] == "fit_operator")


@pytest.mark.parametrize("gram", ["int8", "fp32", "auto"])
def test_fit_plan_matches_jax(gram):
    conf = jm.MnistRandomFFTConfig(synthetic=N, num_ffts=NUM_FFTS, block_size=BLOCK)
    train = jm._load(conf, "train")
    jbf = jm.build_batch_featurizers(NUM_FFTS, BLOCK, seed=0)
    signs = [[np.asarray(c.nodes[0].signs) for c in batch] for batch in jbf]
    jp = jplan.plan_fit(
        JChained(
            prefix=jm.FeaturizerBank(batches=tuple(tuple(g) for g in jbf)),
            est=JBLS(block_size=BLOCK, lam=0.01),
        ),
        jnp.asarray(train.data),
        JCLI(num_classes=10)(train.labels),
        n_valid=len(train),
        gram=gram,
        chunk_size=CHUNK,
    )
    tp = tplan.plan_fit(
        ChainedLabelEstimator(
            prefix=convert.featurizer_bank(signs, device="cpu"),
            est=BlockLeastSquaresEstimator(block_size=BLOCK, lam=0.01),
        ),
        torch.from_numpy(train.data),
        ClassLabelIndicators(num_classes=10)(train.labels),
        device=CPU,
        n_valid=len(train),
        gram=gram,
        chunk_size=CHUNK,
    )
    assert tp.fit.fused and jp.fit.fused
    assert (tp.fit.d, tp.fit.k) == (jp.fit.d, jp.fit.k) == (NUM_FFTS * BLOCK, 10)
    assert tuple(tp.fit.widths) == tuple(jp.fit.widths)
    assert tp.chunk_size == jp.chunk_size == CHUNK
    t_op, j_op = tp.decision("fit_operator"), _fit_operator(jp.decisions)
    # on the CPU neither package may pick int8 unasked (no int8 advantage)
    assert t_op["op"] == j_op["op"] == ("fp32" if gram == "auto" else gram)
    assert t_op["reason"] == j_op["reason"]
    if t_op["quantization_error"] is not None:
        assert t_op["quantization_error"] == pytest.approx(j_op["quantization_error"], rel=1e-3)
    j_fuse = [d for d in jp.decisions if d["action"] == "fuse_fit"][-1]
    assert tp.decision("fuse_fit")["nodes_fused"] == j_fuse["nodes_fused"]


def test_sampled_nodes_carry_wall_time_not_flops():
    chain = chain_from(Pipeline.of(transformer(lambda x: x * 2.0, "double")))
    out = costs.sample_chain(chain, torch.ones(64, 8), CPU)
    assert torch.equal(out, torch.full((64, 8), 2.0))
    cost = chain[0].cost
    assert cost.source == "sampled"
    assert cost.wall_s is not None and cost.wall_s >= 0.0
    assert cost.flops == 0.0
    assert cost.input_bytes == cost.output_bytes == 8 * 4


def _refuses(exc):
    def fn(batch):
        raise exc("probe refused")

    return transformer(fn, "refuses")


@pytest.mark.parametrize("exc", [TypeError, ValueError, RuntimeError])
def test_unprobeable_prefix_falls_back_with_its_label(exc):
    x = torch.ones(32, 4)
    y = ClassLabelIndicators(num_classes=3)(np.arange(32) % 3)
    plan = tplan.plan_fit(
        ChainedLabelEstimator(prefix=_refuses(exc), est=BlockLeastSquaresEstimator(block_size=4)),
        x,
        y,
        device=CPU,
    )
    assert not plan.fit.fused
    assert plan.decision("fit_fallback") == {
        "action": "fit_fallback",
        "reason": "unprobeable_prefix",
        "nodes": ["00:refuses"],
    }


def test_apply_plan_records_nodes_left_at_default_cost():
    pipe = Pipeline.of(transformer(lambda x: x + 1.0, "inc"), _refuses(TypeError))
    plan = tplan.plan_pipeline(pipe, sample=torch.zeros(16, 4), device=CPU)
    assert plan.prefix[0].cost.source == "sampled"
    assert plan.prefix[1].cost.source == "default"
    assert plan.decision("cost_default") == {
        "action": "cost_default",
        "reason": "unprobeable",
        "nodes": ["01:refuses"],
    }
