"""``python -m keystone_tpu_torch plan <model>`` — print a model's chosen plan.

Port of ``keystone_tpu/plan/cli.py``: builds a small representative apply
pipeline of the port's own nodes for the named model (tiny synthetic
inputs — no downloads, no full run), plans it on the device, and prints
the plan: nodes, per-row cost estimates, cache points, applied rewrites,
the chunk choice, and the device kind it was planned for. Nothing beyond
the bounded profiling sample executes. ``--device`` picks the device
(default: the card).
"""

from __future__ import annotations

import numpy as np
import torch


def _mnist_pipeline(device: torch.device):
    """Fitted MNIST random-FFT apply pipeline on a tiny synthetic fit."""
    from keystone_tpu_torch.core.pipeline import Pipeline
    from keystone_tpu_torch.models.mnist_random_fft import FeaturizerBank
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(128, 784)).astype(np.float32)).to(device)
    y = ClassLabelIndicators(num_classes=10)(rng.integers(0, 10, size=128).astype(np.int32))
    bank = FeaturizerBank.create(num_ffts=2, block_size=1024, seed=0, device=device)
    model = BlockLeastSquaresEstimator(block_size=1024, num_iter=1, lam=1.0).fit(
        bank(x), y.to(device)
    )
    return Pipeline.of(bank, model, MaxClassifier()), x


def _cifar_pipeline(device: torch.device):
    """CIFAR random-patch conv featurization chain (random filters — the
    fit-free slice that exercises the conv rewrite rule)."""
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.ops.images import ImageVectorizer, Pooler, SymmetricRectifier

    rng = np.random.default_rng(1)
    patch, filters = 6, 64
    d = patch * patch * 3
    pipe = (
        convert.convolver(
            rng.normal(size=(filters, d)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32),
            device=device,
            patch_size=patch,
            normalize_patches=True,
        )
        >> SymmetricRectifier(alpha=0.25)
        >> Pooler(stride=13, pool_size=14)
        >> ImageVectorizer()
    )
    x = torch.from_numpy(rng.normal(size=(32, 32, 32, 3)).astype(np.float32)).to(device)
    return pipe, x


def _mnist_fit_plan(device: torch.device, chunk_size=None, budget_bytes=None):
    """The fused streaming-fit plan for an MNIST-shaped chained fit:
    featurizer bank → block least squares, absorbed into one
    streaming-fit node with the Gram-operator decision recorded."""
    from keystone_tpu_torch import plan as plan_mod
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
    from keystone_tpu_torch.models.mnist_random_fft import FeaturizerBank
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicators

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(512, 784)).astype(np.float32))
    y = ClassLabelIndicators(num_classes=10)(rng.integers(0, 10, size=512).astype(np.int32))
    chain = ChainedLabelEstimator(
        prefix=FeaturizerBank.create(num_ffts=2, block_size=1024, seed=0, device=device),
        est=BlockLeastSquaresEstimator(block_size=1024, num_iter=1, lam=1.0),
    )
    return plan_mod.plan_fit(
        chain, x, y, device=device, chunk_size=chunk_size, budget_bytes=budget_bytes
    )


BUILDERS = {
    "mnist-random-fft": _mnist_pipeline,
    "cifar-random-patch": _cifar_pipeline,
}

FIT_BUILDERS = {
    "mnist-random-fft": _mnist_fit_plan,
}


def main(argv: list[str] | None = None) -> None:
    import argparse

    from keystone_tpu_torch.core.runtime import resolve_device

    parser = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch plan",
        description=(
            "print the cost-based planner's chosen plan for a model "
            "(nodes, costs, cache points, rewrites) without executing it"
        ),
    )
    parser.add_argument("model", choices=sorted(BUILDERS))
    parser.add_argument(
        "--fit",
        action="store_true",
        help="plan the model's FIT path (fused streaming normal-equations "
        "accumulation + Gram-operator choice) instead of its apply path",
    )
    parser.add_argument(
        "--learned",
        action="store_true",
        help="show the KEYSTONE_PLAN_STORE record for this model's "
        "pipeline (final knob settings + provenance) instead of "
        "re-planning it",
    )
    parser.add_argument("--chunk-size", type=int, default=None, help="force executor chunk size")
    parser.add_argument(
        "--budget-mb",
        type=float,
        default=None,
        help="memory budget for cached intermediates (default: "
        "KEYSTONE_PLAN_BUDGET_MB or the device's memory)",
    )
    parser.add_argument(
        "--rows",
        type=int,
        default=65536,
        help="assumed execution batch size for the chunk-size choice",
    )
    parser.add_argument("--device", default=None, help="device to plan for (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    budget = None if args.budget_mb is None else int(args.budget_mb * 2**20)

    from keystone_tpu_torch import plan as plan_mod

    if args.learned:
        from keystone_tpu_torch.plan import costs
        from keystone_tpu_torch.plan import store as plan_store
        from keystone_tpu_torch.plan.ir import chain_from

        base = plan_store.store_dir()
        if not base:
            raise SystemExit("--learned needs KEYSTONE_PLAN_STORE set to the plan-store directory")
        pipe, _probe = BUILDERS[args.model](device)
        # the same identity plan_pipeline fingerprints: the pre-rewrite
        # node-label chain
        fp = plan_store.fingerprint([pn.label for pn in chain_from(pipe)])
        kind = costs.device_kind(device)
        try:
            rec = plan_store.load(fp, device_kind=kind)
        except plan_store.PlanStoreError as e:
            raise SystemExit(str(e)) from None
        if rec is None:
            others = plan_store.entries()
            print(
                f"{args.model}: no learned plan stored for fingerprint "
                f"{fp} on this device kind ({kind}) under {base}"
            )
            if others:
                print(f"({len(others)} record(s) for other pipelines/devices:)")
                for other in others[:8]:
                    for line in plan_store.describe(other):
                        print("  " + line)
            return
        print(f"{args.model}  [{base}]")
        for line in plan_store.describe(rec):
            print(line)
        return

    if args.fit:
        if args.model not in FIT_BUILDERS:
            raise SystemExit(f"--fit supports: {', '.join(sorted(FIT_BUILDERS))}")
        plan = FIT_BUILDERS[args.model](device, chunk_size=args.chunk_size, budget_bytes=budget)
        print(f"{args.model} fit (sampled on {plan.rows} rows, plan only — not executed)")
        print(plan.explain())
        return

    pipe, probe = BUILDERS[args.model](device)
    plan = plan_mod.plan_pipeline(
        pipe,
        sample=probe,
        device=device,
        budget_bytes=budget,
        chunk_size=args.chunk_size,
        n_rows=args.rows,
    )
    print(f"{args.model} (sampled on {plan.rows} rows, plan only — not executed)")
    print(plan.explain())


if __name__ == "__main__":
    main()
