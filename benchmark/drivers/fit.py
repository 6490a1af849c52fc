"""Back-to-back streamed fits of the MNIST random-FFT pipeline: a closed
loop with one fit in flight, each over every training row.

The system under test is the port's main path: the featurizer bank of
``models/mnist_random_fft`` in front of ``BlockLeastSquaresEstimator``,
fitted by ``plan.fit_streaming`` (the planner and its quantization gate,
the executor's chunk stream with the int8 Gram K1, the Gram-form solve).
The rows are made from the seed and held on the host, as the entry
takes them; the random signs are drawn by the benchmark from the seed
and handed to the program's featurizer nodes and to the reference alike.

With ``--trace 1`` each fit runs the three public stages that
``fit_streaming`` composes, with a span around each, and the first
``trace_fits`` fits of the window run under the profiler.

``correct``: every fit of the window is judged against the float64
reference fit of the same rows and signs by the relative gap of its
predictions on every training row (``fit_pred_err``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from benchmark.harness import peaks
from benchmark.harness import traffic as _traffic
from benchmark.harness.trace import annotate, traced_window
from benchmark.reference import mnist_random_fft as reference
from benchmark.work import fit as work


def build(run, x, labels, signs):
    """The program's fit: (chained estimator, labels as ±1 indicators)."""
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
    from keystone_tpu_torch.models.mnist_random_fft import FeaturizerBank, fft_features
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats import LinearRectifier, PaddedFFT, RandomSignNode
    from keystone_tpu_torch.ops.util import ClassLabelIndicators

    cfg = run.config
    dev = torch.device(run.device)
    chains = [RandomSignNode(signs=s.to(dev)) >> PaddedFFT() >> LinearRectifier() for s in signs]
    per_batch = max(cfg["blockSize"] // fft_features(x.shape[1]), 1)
    bank = FeaturizerBank(
        batches=tuple(tuple(chains[i : i + per_batch]) for i in range(0, len(chains), per_batch))
    )
    est = BlockLeastSquaresEstimator(
        block_size=cfg["blockSize"], num_iter=cfg["solver_passes"], lam=cfg["lambda"]
    )
    y = ClassLabelIndicators(num_classes=cfg["num_classes"])(labels)
    return ChainedLabelEstimator(prefix=bank, est=est), y


def _model_of(fitted) -> tuple:
    """(X (D, K), μ (D,), b (K,)) of a fitted pipeline's linear model."""
    m = fitted[-1]
    return (torch.cat(list(m.xs), dim=0).detach(), torch.cat(list(m.means)).detach(),
            m.b.detach())


def fit_in_stages(chain, x, y, n: int, dev, sync, span) -> tuple:
    """What ``plan.fit_streaming`` runs, as its three public stages
    (``plan_fit``, ``fit_stream``, ``fit_stats_finalize``), each in a
    span: ``span(name, seconds)``; returns (fitted pipeline, plan). A plan
    that does not fuse is fitted by ``fit_streaming`` itself and no span
    is recorded."""
    from keystone_tpu_torch import plan as plan_mod
    from keystone_tpu_torch.core.pipeline import Pipeline

    t0 = time.perf_counter()
    with annotate("bench.plan"):
        plan = plan_mod.plan_fit(chain, x, y, device=dev, n_valid=n)
        sync()
    t1 = time.perf_counter()
    if not plan.fit.fused:
        return plan_mod.fit_streaming(chain, x, y, n_valid=n, device=dev), plan
    with annotate("bench.stream"):
        state = plan_mod.fit_stream(plan, x, y, n_valid=n)
        sync()
    t2 = time.perf_counter()
    with annotate("bench.solve"):
        model = chain.est.fit_stats_finalize(state, widths=plan.fit.widths)
        sync()
    t3 = time.perf_counter()
    span("fit.plan", t1 - t0)
    span("fit.stream", t2 - t1)
    span("fit.solve", t3 - t2)
    return Pipeline.of(chain.prefix, model), plan


def plan_summary(plan) -> str:
    """What varies between fits' plans, in one line: whether the fit
    fused, the chunk, the staging depth and the Gram's operator, each
    with what chose it."""
    if not plan.fit.fused:
        return f"not fused: {plan.decisions}"
    chunk = plan.decision("chunk") or {}
    stage = plan.decision("stage") or {}
    return (f"chunk {plan.chunk_size} ({chunk.get('source') or chunk.get('reason') or 'budget'}), "
            f"stage depth {plan.stage_depth} ({stage.get('source')}), gram {plan.fit.gram}")


def run(run) -> None:
    from keystone_tpu_torch import plan as plan_mod
    from keystone_tpu_torch.core.runtime import resolve_device

    cfg, p = run.config, run.params
    os.environ["KEYSTONE_GRAM_OP"] = cfg["gram_op"]
    dev = resolve_device(run.device)  # as the entry takes it: float32 stays float32
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n, d, k = cfg["num_train"], cfg["image_dim"], cfg["num_classes"]
    x, labels = _traffic.mnist_rows(run.seed, n, d, k, dev)
    signs = _traffic.fft_signs(run.seed, cfg["numFFTs"], d)
    chain, y = build(run, x, labels, signs)

    def fit_plain():
        return plan_mod.fit_streaming(chain, x, y, n_valid=n, device=dev, return_plan=True)

    def fit_staged():
        return fit_in_stages(chain, x, y, n, dev, sync, run.span)

    fit_with_plan = fit_staged if run.trace else fit_plain
    plans: dict = {}  # plan_summary of the window's fits: [fits, chunk rows]

    def fit_one(counted: bool = True):
        fitted, plan = fit_with_plan()
        if counted:
            seen = plans.setdefault(plan_summary(plan), [0, plan.chunk_size or n])
            seen[0] += 1
        return fitted

    for _ in range(int(p["warm_fits"])):
        fit_one(counted=False)
        sync()

    models, walls = [], []
    holder: dict = {}
    trace_fits = int(p["trace_fits"]) if run.trace and dev.type == "cuda" else 0
    t_start = run.start_window()
    profiled = traced_window(run.trace_path, holder) if trace_fits else contextlib.nullcontext()
    with profiled:
        for _ in range(trace_fits):
            t0 = time.perf_counter()
            with annotate("bench.fit"):
                models.append(_model_of(fit_one()))
                sync()
            walls.append(time.perf_counter() - t0)
    t_start += holder.get("overhead_s", 0.0)  # the profiler's own, left out
    while not models or time.perf_counter() - t_start < run.seconds:
        t0 = time.perf_counter()
        models.append(_model_of(fit_one()))
        sync()
        walls.append(time.perf_counter() - t0)
    t_end = time.perf_counter()
    window = t_end - t_start
    run.attempted = len(models)
    run.metrics["fit_rows_per_s"] = n * len(models) / window
    w = sorted(walls)
    run.log(f"window {window:.3f} s: {len(models)} fits, a fit's wall min {w[0]:.4f} "
            f"median {w[len(w) // 2]:.4f} max {w[-1]:.4f} s")
    for key, (count, _) in sorted(plans.items(), key=lambda kv: -kv[1][0]):
        run.log(f"plan of {count} fit(s): {key}")
    if any(key.startswith("not fused") for key in plans):
        run.log("plan_fit did not fuse; the stage split is not reported")
        run.record["spans"].clear()
    run.read_memory_peak()

    stage_s = work.fit_stage_seconds(cfg, peaks)
    dim = work.features(cfg)
    chunk = max(plans.values())[1]  # the commonest plan's
    rec = run.record
    rec["trace"] = holder.get("trace")
    rec["work"].update(
        fits=len(models), fit_walls_s=walls, window_s=window, traced_fits=trace_fits,
        fit_bound_s=sum(stage_s.values()),
        # K1's calls in the traced fits: one a chunk, the valid rows' need
        k1_bound_s=trace_fits * sum(
            peaks.bound_s(work.gram_ops(min(chunk, n - s), dim),
                             work.gram_bytes(min(chunk, n - s), dim), cfg["gram_op"])[0]
            for s in range(0, n, chunk)
        ),
    )

    del chain
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference.fit(x, labels, signs, cfg, dev)
    errs = reference.prediction_errors(x, signs, ref, models, dev)
    run.check("fit_pred_err", max(errs), run.limits["fit_pred_err"])
    run.check("fit_mean_err", max(reference.mean_errors(ref, models)), run.limits["fit_mean_err"])
    run.record["check_s"] = time.perf_counter() - t_check
    if run.control:
        low = reference.fit(x, labels, signs, cfg, dev, gram_bits=int(p["control_gram_bits"]),
                            feature_bits=int(p["control_feature_bits"]))
        run.check_control("fit_pred_err", reference.prediction_errors(x, signs, ref, [low], dev)[0])
        run.check_control("fit_mean_err", reference.mean_errors(ref, [low])[0])
