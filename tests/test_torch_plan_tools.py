"""keystone_tpu_torch's planner tools against the JAX package's: the plan
store (fingerprints, records each package writes and the other loads, the
device-kind and fingerprint refusals), ``choose_materialization`` (the
same costs and budget give the same decisions, the cases of
``tests/test_plan.py:68-117`` included), ``fit_shared`` on a narrow
MNIST-like chain (weights within 1e-5 of max|W|, the prefix applied once,
the over-budget route), the planner's seeding from the store and the
autotuner, recorded cost profiles read before sampling, and the ``plan``
CLI on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu import plan as jplan  # noqa: E402
from keystone_tpu.core.pipeline import ChainedLabelEstimator as JChained  # noqa: E402
from keystone_tpu.core.pipeline import transformer as j_transformer  # noqa: E402
from keystone_tpu.models import mnist_random_fft as jm  # noqa: E402
from keystone_tpu.observe import metrics as j_metrics  # noqa: E402
from keystone_tpu.ops.linear import BlockLeastSquaresEstimator as JBLS  # noqa: E402
from keystone_tpu.ops.util import ClassLabelIndicators as JCLI  # noqa: E402
from keystone_tpu.plan import ir as j_ir  # noqa: E402
from keystone_tpu.plan import passes as j_passes  # noqa: E402
from keystone_tpu.plan import store as j_store  # noqa: E402
from keystone_tpu.plan import tune as j_tune  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch import plan as tplan  # noqa: E402
from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Pipeline, transformer  # noqa: E402
from keystone_tpu_torch.observe import cost as t_cost  # noqa: E402
from keystone_tpu_torch.observe import metrics  # noqa: E402
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator  # noqa: E402
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier  # noqa: E402
from keystone_tpu_torch.plan import costs as t_costs  # noqa: E402
from keystone_tpu_torch.plan import ir as t_ir  # noqa: E402
from keystone_tpu_torch.plan import passes as t_passes  # noqa: E402
from keystone_tpu_torch.plan import store as t_store  # noqa: E402
from keystone_tpu_torch.plan import tune as t_tune  # noqa: E402

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_TOL = 1e-5  # of max|W|


def _counter(reg, name):
    return reg.get_registry().snapshot().get(name, 0)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.delenv("KEYSTONE_TUNE", raising=False)
    monkeypatch.delenv("KEYSTONE_PLAN_STORE", raising=False)
    monkeypatch.delenv("KEYSTONE_STAGE_DEPTH", raising=False)
    t_tune.reset()
    j_tune.reset()
    yield
    t_tune.reset()
    j_tune.reset()


# ---------------------------------------------------------------- store


@pytest.mark.parametrize("labels,extra", [(["00:Scale", "01:<lambda>"], {}),
                                          (["00:FeaturizerBank"], {"rows": 60000}),
                                          ([], {"x": [1, 2]})])
def test_store_fingerprints_match_jax(labels, extra):
    assert t_store.fingerprint(labels, **extra) == j_store.fingerprint(labels, **extra)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_records_cross_load(tmp_path, writer):
    """A record either package writes, the other loads, and both describe
    it the same way; another device kind finds nothing; a record whose
    embedded fingerprint disagrees is refused by both."""
    fp = t_store.fingerprint(["00:FeaturizerBank", "01:BlockLinearMapper"])
    rec = {"knobs": {"stage_depth": 3, "chunk_rows": 2048},
           "plan": {"chunk_size": 2048, "stage_depth": 3, "nodes": ["00:A", "01:B"]},
           "provenance": {"run": "r1", "goodput": 12.5, "evals": 4}}
    save, load = (t_store, j_store) if writer == "port" else (j_store, t_store)
    path = save.save(fp, rec, device_kind="NVIDIA H100 80GB HBM3", base=str(tmp_path))
    assert os.path.basename(path) == f"{fp}__NVIDIA-H100-80GB-HBM3.json"
    for mod in (t_store, j_store):
        got = mod.load(fp, device_kind="NVIDIA H100 80GB HBM3", base=str(tmp_path))
        assert got["knobs"] == rec["knobs"] and got["plan"] == rec["plan"]
        assert mod.load(fp, device_kind="cpu", base=str(tmp_path)) is None
    assert t_store.describe(got) == j_store.describe(got)
    assert [r["fingerprint"] for r in t_store.entries(str(tmp_path))] == [fp]
    with open(path) as f:
        payload = json.load(f)
    payload["fingerprint"] = "0" * 16
    with open(path, "w") as f:
        json.dump(payload, f)
    for mod in (t_store, j_store):
        with pytest.raises(mod.PlanStoreError, match="refusing"):
            mod.load(fp, device_kind="NVIDIA H100 80GB HBM3", base=str(tmp_path))


def test_store_is_off_without_its_env_and_survives_a_torn_file(tmp_path, monkeypatch):
    assert t_store.save("abc", {}) is None and t_store.load("abc") is None
    monkeypatch.setenv("KEYSTONE_PLAN_STORE", str(tmp_path))
    (tmp_path / "abc__cpu.json").write_text("{not json")
    before = _counter(metrics, "plan_store_corrupt")
    assert t_store.load("abc", device_kind="cpu") is None
    assert _counter(metrics, "plan_store_corrupt") == before + 1


# ------------------------------------------------------ materialization


def _mat_case(ir, passes, tf, output_bytes, budget, reuse, rows, exec_rows, wall, branches):
    node = ir.PlanNode(
        label="feat",
        op=tf(lambda b: b),
        cost=(ir.NodeCost() if wall is None
              else ir.NodeCost(output_bytes=output_bytes, wall_s=wall, source="sampled")),
        reuse=reuse,
    )
    head = ir.PlanNode(label="head", op=tf(lambda b: b),
                       cost=ir.NodeCost(output_bytes=4.0, wall_s=2e-4, source="sampled"))
    p = ir.Plan(prefix=[head, node], branches=[[] for _ in range(branches)],
                budget_bytes=budget, rows=rows)
    passes.choose_materialization(p, rows=exec_rows)
    return [n.materialize for n in p.prefix], p.share_prefix, p.decisions


@pytest.mark.parametrize(
    "output_bytes,budget,reuse,rows,exec_rows,wall,branches",
    [
        (10.0, 10_000, 3, 100, None, 1e-3, 2),  # fits: cache (test_plan.py:68)
        (1000.0, 10_000, 3, 100, None, 1e-3, 2),  # over budget: refused
        (10.0, 10_000, 2, 100, 100_000, 1e-3, 1),  # priced at execution rows (:99)
        (0.0, 1 << 20, 2, 0, None, None, 1),  # unknown costs share (:114)
        (10.0, 10_000, 1, 100, None, 1e-3, 0),  # no reuse: no candidate
        (8.0, 1 << 30, 4, 256, 60_000, 0.0, 3),  # zero benefit: no cache
    ],
)
def test_choose_materialization_matches_jax(output_bytes, budget, reuse, rows, exec_rows, wall,
                                            branches):
    args = (output_bytes, budget, reuse, rows, exec_rows, wall, branches)
    got = _mat_case(t_ir, t_passes, transformer, *args)
    want = _mat_case(j_ir, j_passes, j_transformer, *args)
    assert got == want


# ----------------------------------------------------------- fit_shared


N, NUM_FFTS, BLOCK, LAMS = 600, 1, 512, (1e7, 1e8)


@pytest.fixture(scope="module")
def mnist_like():
    conf = jm.MnistRandomFFTConfig(synthetic=N, num_ffts=NUM_FFTS, block_size=BLOCK)
    train = jm._load(conf, "train")
    jbf = jm.build_batch_featurizers(NUM_FFTS, BLOCK, seed=0)
    signs = [[np.asarray(c.nodes[0].signs) for c in batch] for batch in jbf]
    return train, jm.FeaturizerBank(batches=tuple(tuple(g) for g in jbf)), signs


def _weights(pipe):
    return np.concatenate([np.asarray(x) for x in pipe.nodes[-1].xs], axis=0)


@pytest.mark.parametrize("budget", [None, 1])
def test_fit_shared_matches_jax(mnist_like, budget):
    """Two block solvers on one featurizer bank: the port's and the JAX
    package's fits agree within 1e-5 of max|W|; within the budget the
    shared prefix runs once on the fit's rows and the saved pass is
    counted, over it (``budget=1``) each chain fits the naive way, as in
    the JAX package. The ridge λs (1e7, 1e8, against a Gram diagonal near
    2.3e5) keep the f32 solve well conditioned, so the comparison reads
    the sharing, not the solve's rounding (at λ 1 the two packages' weights
    read 4.4e-4 apart; ``test_torch_mnist.py`` holds that solve at 1e-3)."""
    train, jbank, signs = mnist_like
    tbank = convert.featurizer_bank(signs, device="cpu")
    x, labels = train.data, train.labels
    jchains = [JChained(prefix=jbank, est=JBLS(block_size=BLOCK, num_iter=1, lam=lam))
               for lam in LAMS]
    tchains = [ChainedLabelEstimator(prefix=tbank,
                                     est=BlockLeastSquaresEstimator(block_size=BLOCK, num_iter=1,
                                                                    lam=lam))
               for lam in LAMS]
    sample = None if budget is None else x
    j_before = _counter(j_metrics, "plan_featurize_passes_saved")
    t_before = _counter(metrics, "plan_featurize_passes_saved")
    calls = {"n": 0}
    featurize = tbank.__class__.__call__

    def counted(self, data):
        calls["n"] += data.shape[0] == N  # the fit's rows, not a cost probe
        return featurize(self, data)

    jfit = jplan.fit_shared(jchains, jnp.asarray(x), JCLI(num_classes=10)(labels),
                            budget_bytes=budget, sample=None if sample is None else jnp.asarray(x))
    tbank.__class__.__call__ = counted
    try:
        tfit = tplan.fit_shared(tchains, torch.from_numpy(x),
                                ClassLabelIndicators(num_classes=10)(labels), device=CPU,
                                budget_bytes=budget, sample=sample)
    finally:
        tbank.__class__.__call__ = featurize
    shared = budget is None
    assert calls["n"] == (1 if shared else 2)
    assert _counter(metrics, "plan_featurize_passes_saved") - t_before == int(shared)
    assert _counter(j_metrics, "plan_featurize_passes_saved") - j_before == int(shared)
    for t, j in zip(tfit, jfit):
        tw, jw = _weights(t), _weights(j)
        assert np.abs(tw - jw).max() / np.abs(jw).max() <= W_TOL
    naive = [c.fit(torch.from_numpy(x), ClassLabelIndicators(num_classes=10)(labels))
             for c in tchains]
    for t, n in zip(tfit, naive):
        np.testing.assert_array_equal(_weights(t), _weights(n))


def test_fit_shared_distinct_prefixes_fit_naively():
    a = transformer(lambda b: b * 2.0, name="a")
    b = transformer(lambda b: b * 3.0, name="b")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(1).normal(size=(40, 2)).astype(np.float32))
    chains = [ChainedLabelEstimator(prefix=p, est=BlockLeastSquaresEstimator(block_size=6, lam=1.0))
              for p in (a, b)]
    before = _counter(metrics, "plan_featurize_passes_saved")
    out = tplan.fit_shared(chains, x, y, device=CPU)
    assert len(out) == 2 and _counter(metrics, "plan_featurize_passes_saved") == before
    assert tplan.fit_shared([], x, y, device=CPU) == []


def test_multi_branch_run_plan_shares_the_prefix():
    """A multi-branch plan runs its prefix once and fans it out; refused,
    each branch recomputes it."""
    calls = {"n": 0}

    def feat(b):
        calls["n"] += 1
        return b + 1.0

    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    for share in (True, False):
        calls["n"] = 0
        plan = t_ir.Plan(
            prefix=[t_ir.PlanNode("00:feat", transformer(feat, name="feat"), reuse=2,
                                  materialize=share)],
            branches=[[t_ir.PlanNode("01:a", transformer(lambda b: b * 2, name="a"))],
                      [t_ir.PlanNode("01:b", transformer(lambda b: b - 1, name="b"))]],
            share_prefix=share,
        )
        before = _counter(metrics, "plan_shared_prefix_applies")
        a, b = plan.execute(x)
        assert torch.equal(a, (x + 1) * 2) and torch.equal(b, x)
        assert calls["n"] == (1 if share else 2)
        assert _counter(metrics, "plan_shared_prefix_applies") - before == int(share)
        assert "branch 1:" in plan.explain()


# ------------------------------------------------------ planner seeding


def _apply_pipes(signs, jbank):
    from keystone_tpu.core.pipeline import Pipeline as JPipeline
    from keystone_tpu.ops.util import MaxClassifier as JMax

    tbank = convert.featurizer_bank(signs, device="cpu")
    return Pipeline.of(tbank, MaxClassifier()), JPipeline.of(jbank, JMax())


def test_plan_seeding_from_the_store_and_the_tuner_matches_jax(mnist_like, tmp_path,
                                                              monkeypatch):
    """A stored record seeds the chunk size and the stage depth with
    ``source="store"`` and a ``learned`` decision; a live autotuner's
    chunk knob wins over the store (``source="autotuner"``); an explicit
    size wins over both. The two packages record the same decisions
    (their device kinds aside)."""
    train, jbank, signs = mnist_like
    tpipe, jpipe = _apply_pipes(signs, jbank)
    x = train.data[:64]
    monkeypatch.setenv("KEYSTONE_PLAN_STORE", str(tmp_path))
    fp = t_store.fingerprint(["00:FeaturizerBank", "01:MaxClassifier"])
    rec = {"knobs": {"stage_depth": 3}, "plan": {"chunk_size": 128, "stage_depth": 3},
           "provenance": {"run": "r0"}}
    t_store.save(fp, rec, device_kind="cpu")
    j_store.save(fp, rec, device_kind=jplan._device_kind())

    def decisions(plan):
        return [{k: v for k, v in d.items() if k in ("action", "size", "source", "depth", "run")}
                for d in plan.decisions if d["action"] in ("chunk", "stage", "learned")]

    got = tplan.plan_pipeline(tpipe, sample=x, device=CPU, n_rows=4096)
    want = jplan.plan_pipeline(jpipe, sample=jnp.asarray(x), n_rows=4096)
    assert decisions(got) == decisions(want)
    assert got.chunk_size == 128 and got.stage_depth == 3
    assert {"action": "chunk", "size": 128, "source": "store"} in decisions(got)

    monkeypatch.setenv("KEYSTONE_TUNE", "1")
    for mod in (t_tune, j_tune):
        mod.reset()
        mod.active().bind_chunk(512, fingerprint=fp)
    got = tplan.plan_pipeline(tpipe, sample=x, device=CPU, n_rows=4096)
    # the stored stage depth a bound tuner applies is written into the
    # process environment, which the two packages share
    monkeypatch.delenv("KEYSTONE_STAGE_DEPTH", raising=False)
    want = jplan.plan_pipeline(jpipe, sample=jnp.asarray(x), n_rows=4096)
    monkeypatch.delenv("KEYSTONE_STAGE_DEPTH", raising=False)
    assert decisions(got) == decisions(want)
    assert got.chunk_size == 512 and got.decision("chunk")["source"] == "autotuner"
    got = tplan.plan_pipeline(tpipe, sample=x, device=CPU, n_rows=4096, chunk_size=64)
    assert got.decision("chunk")["source"] == "requested"
    # the tuner is bound to the store identity: a flush persists the
    # tuned chunk for the next run
    t_tune.active().flush()
    assert t_store.load(fp, device_kind="cpu")["plan"]["chunk_size"] == 512


def test_recorded_profiles_cost_the_plan_before_sampling():
    """``attach`` reads the process cost registry first: a profiled node
    takes ``source="profile"`` normalized by the profile's own rows, and
    only unprofiled nodes are sampled."""
    node = transformer(lambda b: b @ torch.ones((8, 4)), name="mm")
    tail = transformer(lambda b: b * 2.0, name="tail")
    x = torch.ones((32, 8))
    reg = t_cost.get_cost_registry()
    reg.reset()
    try:
        reg.profile_node(node, torch.ones((16, 8)), label="00:mm")
        chain = t_ir.chain_from(Pipeline.of(node, tail))
        t_costs.attach(chain, x, CPU)
        assert chain[0].cost.source == "profile"
        assert chain[0].cost.flops == pytest.approx(2 * 8 * 4)  # per row
        assert chain[1].cost.source == "sampled" and chain[1].cost.wall_s is not None
    finally:
        reg.reset()


# --------------------------------------------------------------- the CLI


def _cli(*args, env=None):
    run = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", "plan", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, **(env or {})))
    assert run.returncode == 0, run.stderr[-2000:]
    return run.stdout


def test_plan_cli_prints_the_plan_for_the_device(tmp_path):
    out = _cli("mnist-random-fft", "--device", "cpu")
    assert "device: cpu" in out and "00:FeaturizerBank" in out and "decisions:" in out
    out = _cli("mnist-random-fft", "--fit", "--device", "cpu")
    assert "fit: fused streaming" in out and "gram=" in out
    out = _cli("cifar-random-patch", "--device", "cpu")
    assert "rewrite" in out
    out = _cli("mnist-random-fft", "--learned", "--device", "cpu",
               env={"KEYSTONE_PLAN_STORE": str(tmp_path)})
    assert "no learned plan stored" in out and "(cpu)" in out
