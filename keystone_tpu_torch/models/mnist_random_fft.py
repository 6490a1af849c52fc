"""MNIST random-FFT pipeline — the port's main path.

Port of ``keystone_tpu/models/mnist_random_fft.py``: random-sign flip →
padded FFT → rectify, ``num_ffts`` independent draws grouped into feature
batches of ``block_size`` columns (512 FFT features per draw on 28×28
inputs), solved with block least squares, argmax classified,
multiclass-evaluated.

Two fit paths, as in the reference:

- classic (``KEYSTONE_PLAN`` unset): every feature block is materialized
  on the device and fitted with the data-form BCD;
- streamed (``KEYSTONE_PLAN=1``): the planner's fused fit streams
  8,192-row chunks through featurize → normal-equation accumulation
  (the int8 Gram, kernel K1, when the planner picks it or
  ``KEYSTONE_GRAM_OP=int8`` asks for it) and solves the Gram-form BCD;
  the train and test passes run through the planned executor.

Across processes (a process group from
:func:`keystone_tpu_torch.parallel.multihost.initialize`, as
``--multihost`` starts), every process draws the same data from the seed
and takes its own row block: the fit merges every process's statistics
and solves on each, the streamed fit runs K1 on every process, and the
errors are global.

Run on the card: ``python -m keystone_tpu_torch.models.mnist_random_fft
--synthetic 60000 --num-ffts 32``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from keystone_tpu_torch import plan as plan_mod
from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.pipeline import (
    ChainedLabelEstimator,
    Pipeline,
    Transformer,
)
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.observe import events as observe_events
from keystone_tpu_torch.loaders.csv_loader import load_labeled_csv
from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.stats import (
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
    _cos_matrix,
    next_pow2,
)
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier, ZipVectors
from keystone_tpu_torch.parallel import multihost
from keystone_tpu_torch.parallel.mesh import (
    create_mesh,
    data_axis_size,
    data_group,
    data_sharding,
    local_position,
)

logger = get_logger("keystone_tpu_torch.models.mnist_random_fft")

NUM_CLASSES = 10
IMAGE_SIZE = 784  # 28 x 28


def fft_features(image_size: int) -> int:
    """PaddedFFT output width for a given input dim: next_pow2 // 2."""
    return next_pow2(image_size) // 2


@dataclasses.dataclass
class MnistRandomFFTConfig:
    """MNIST random-FFT workload (reference MnistRandomFFTConfig)."""

    train_location: str = arg(default="", help="train csv (label first, 1-indexed)")
    test_location: str = arg(default="", help="test csv")
    num_ffts: int = arg(default=200, help="number of random FFT draws")
    block_size: int = arg(default=2048, help="solver block size (multiple of 512)")
    lam: float = arg(default=0.0, help="L2 regularization")
    seed: int = arg(default=0)
    synthetic: int = arg(
        default=0, help="if > 0, run on N synthetic samples instead of csvs"
    )


def build_batch_featurizers(
    num_ffts: int,
    block_size: int,
    seed: int,
    image_size: int = IMAGE_SIZE,
    device: torch.device | str | None = None,
) -> list[list[Pipeline]]:
    """Group ``num_ffts`` (sign → fft → relu) chains into batches whose
    concatenated width is ``block_size`` (last batch may be smaller). The
    signs are drawn in order from one ``torch.Generator`` seeded with
    ``seed`` and placed on ``device``: the card unless the caller asks for
    the CPU."""
    device = resolve_device(device)
    ffts_per_batch = max(block_size // fft_features(image_size), 1)
    gen = torch.Generator().manual_seed(seed)
    chains = [
        RandomSignNode.create(image_size, gen, device)
        >> PaddedFFT()
        >> LinearRectifier()
        for _ in range(num_ffts)
    ]
    return [chains[i : i + ffts_per_batch] for i in range(0, num_ffts, ffts_per_batch)]


@dataclasses.dataclass(eq=False)
class FeaturizerBank(Transformer):
    """The full random-FFT featurizer as one Transformer: applies every
    feature batch and returns the list of (N, ≤block_size) blocks."""

    batches: tuple  # tuple of tuples of (sign → fft → relu) Pipelines

    @staticmethod
    def create(
        num_ffts: int,
        block_size: int,
        seed: int,
        image_size: int = IMAGE_SIZE,
        device: torch.device | str | None = None,
    ) -> "FeaturizerBank":
        groups = build_batch_featurizers(
            num_ffts, block_size, seed, image_size, device
        )
        return FeaturizerBank(batches=tuple(tuple(g) for g in groups))

    def __call__(self, data):
        return featurize(self.batches, data)


def _sign_fft_relu_parts(chain):
    """Match the ``RandomSignNode >> PaddedFFT >> LinearRectifier`` shape;
    returns (signs, fft node, alpha, max_val) or None."""
    nodes = getattr(chain, "nodes", ())
    if len(nodes) != 3:
        return None
    s, f, r = nodes
    if not (
        isinstance(s, RandomSignNode)
        and isinstance(f, PaddedFFT)
        and isinstance(r, LinearRectifier)
    ):
        return None
    return s.signs, f, r.alpha, r.max_val


def _featurize_fused(signs_mat, data, n: int, alpha: float, max_val: float):
    """All chains of one feature batch as ONE gemm: the sign flip is a
    diagonal on the gemm's contraction side, so k chains fold into
    ``relu(X @ [diag(s_1)C | … | diag(s_k)C])``."""
    d = data.shape[-1]
    cos = _cos_matrix(d, n, data.dtype, str(data.device))  # (d, n//2)
    # w in (d, k·n/2) chain-major layout
    w = (signs_mat.T[:, :, None] * cos[:, None, :]).reshape(d, -1)
    return torch.clamp_min(data @ w - alpha, max_val)


def featurize(batch_featurizers, data) -> list:
    """Apply each batch of chains → list of (N, ≤block_size) feature
    blocks. When a batch is all (sign → fft → relu) chains whose FFT
    resolves to the matmul backend (on the card), the whole batch runs as
    one fused gemm; the values are the chain path's either way."""
    out = []
    for chains in batch_featurizers:
        parts = [_sign_fft_relu_parts(c) for c in chains]
        fusable = len(parts) > 0 and all(p is not None for p in parts)
        if fusable:
            signs, ffts, alphas, maxvals = zip(*parts)
            fusable = (
                len(set(alphas)) == 1
                and len(set(maxvals)) == 1
                and all(f.resolve_impl(data) == "matmul" for f in ffts)
            )
        if fusable:
            n = 2 * fft_features(signs[0].shape[-1])
            out.append(
                _featurize_fused(torch.stack(signs), data, n, alphas[0], maxvals[0])
            )
        else:
            out.append(ZipVectors()([chain(data) for chain in chains]))
    return out


def _load(conf: MnistRandomFFTConfig, which: str) -> LabeledData:
    if conf.synthetic:
        n = conf.synthetic if which == "train" else max(conf.synthetic // 6, 1)
        rng = np.random.default_rng(0 if which == "train" else 1)
        labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
        # class-dependent means (shared across splits) so the linear model
        # has signal to find
        centers = (
            np.random.default_rng(42)
            .normal(size=(NUM_CLASSES, IMAGE_SIZE))
            .astype(np.float32)
        )
        data = centers[labels] + rng.normal(size=(n, IMAGE_SIZE)).astype(np.float32)
        return LabeledData(labels=labels, data=data)
    path = conf.train_location if which == "train" else conf.test_location
    return _load_mnist_csv(path)


def _load_mnist_csv(path: str) -> LabeledData:
    from keystone_tpu_torch.loaders.idx import (
        guess_labels_path,
        is_idx_path,
        load_labeled_idx,
    )

    if is_idx_path(path):
        labels = guess_labels_path(path)
        if labels is None:
            raise FileNotFoundError(
                f"{path} looks like an IDX images file but no labels "
                "sibling (…labels-idx1…) was found next to it"
            )
        return load_labeled_idx(path, labels)
    # the reference's MNIST csvs carry 1-indexed labels
    return load_labeled_csv(path, label_offset=1)


def run(conf: MnistRandomFFTConfig, device=None, mesh=None) -> dict:
    """Fit and evaluate on ``device`` (default: the card). The result
    holds the errors, phase times, test predictions and, for the streamed
    fit, the planner's decisions: the fit's and each planned pass's.

    In a process group of several processes (or over a ``mesh`` across
    processes) each process fits and evaluates the row block of its data
    position on its own card; the errors and the test predictions are
    global, on every process. The model positions of a (data, model) mesh
    hold replicas of their data row's block, which the merges and the
    evaluator count once."""
    if mesh is None and multihost.process_count() > 1:
        mesh = create_mesh()
    dp = mesh is not None and mesh.spans_processes
    device = data_sharding(mesh) if dp else resolve_device(device)
    t0 = time.perf_counter()

    train = _load(conf, "train")
    test = _load(conf, "test")
    n_train, n_test = len(train), len(test)
    # rows stay on the host: the streamed fit and the planned passes
    # stage them chunk by chunk; the classic path moves them whole
    train_x = torch.from_numpy(train.data)
    test_x = torch.from_numpy(test.data)
    label_indicators = ClassLabelIndicators(num_classes=NUM_CLASSES)(train.labels)
    # this process's rows: all of them alone, its row block in a group
    train_lo, train_hi = _rows_of(n_train, mesh if dp else None)
    test_lo, test_hi = _rows_of(n_test, mesh if dp else None)
    rows_group = data_group(mesh)

    batch_featurizers = build_batch_featurizers(
        conf.num_ffts,
        conf.block_size,
        conf.seed,
        # width from the data, not the MNIST constant — any row width works
        image_size=train.data.shape[-1],
        device=device,
    )
    bank = FeaturizerBank(batches=tuple(tuple(g) for g in batch_featurizers))
    t_load = time.perf_counter()

    # KEYSTONE_PLAN: the TRAIN fit streams — featurize + normal-equation
    # accumulation fused per chunk by the planner (plan/fused_fit.py), so
    # the feature blocks are never materialized for the fit
    streamed_fit = plan_mod.enabled()
    train_blocks = None
    if not streamed_fit:
        train_blocks = featurize(batch_featurizers, train_x[train_lo:train_hi].to(device))
        synchronize(device)
    t_feat = time.perf_counter()

    est = BlockLeastSquaresEstimator(block_size=conf.block_size, num_iter=1, lam=conf.lam)
    fit_plan = None
    if streamed_fit:
        fitted, fit_plan = plan_mod.fit_streaming(
            ChainedLabelEstimator(prefix=bank, est=est),
            train_x,
            label_indicators,
            n_valid=n_train,
            device=device,
            return_plan=True,
            mesh=mesh,
        )
        model = fitted[-1]
    elif dp:
        model = est.fit(
            multihost.GlobalRows(train_blocks, n_train, train_lo, rows_group),
            label_indicators[train_lo:train_hi].to(device),
        )
    else:
        model = est.fit(train_blocks, label_indicators.to(device), n_valid=n_train)
    synchronize(device)
    t_fit = time.perf_counter()

    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    classify = MaxClassifier()
    errors: dict[str, float] = {}
    preds: dict[str, torch.Tensor] = {}
    apply_decisions: dict[str, list] = {}

    def streaming_eval(name: str, labels: np.ndarray, n_valid: int, lo: int = 0):
        def cb(partial_pred):
            preds[name] = classify(partial_pred)
            if dp:
                preds[name] = multihost.GlobalRows(preds[name], n_valid, lo, rows_group)
            errors[name] = evaluator(preds[name], labels, n_valid=n_valid).error
            logger.info("%s error so far: %.2f%%", name, 100 * errors[name])

        return cb

    if streamed_fit:
        # blocks were never materialized: both passes run through the
        # planned executor (featurizer bank → block model → argmax)
        apply = Pipeline.of(bank, model, MaxClassifier())
        for name, x, split in (("train", train_x, train), ("test", test_x, test)):
            apply_plan = plan_mod.plan_pipeline(apply, sample=x, device=device,
                                                n_rows=int(x.shape[0]), mesh=mesh)
            apply_decisions[name] = apply_plan.decisions
            preds[name] = plan_mod.run_plan(apply_plan, x)
            errors[name] = evaluator(preds[name], split.labels, n_valid=len(split)).error
            logger.info("%s error (planned): %.2f%%", name, 100 * errors[name])
    else:
        model.apply_and_evaluate(
            train_blocks, streaming_eval("train", train.labels, n_train, train_lo))
        del train_blocks
        test_blocks = featurize(batch_featurizers, test_x[test_lo:test_hi].to(device))
        model.apply_and_evaluate(
            test_blocks, streaming_eval("test", test.labels, n_test, test_lo))
    if dp:
        # the global test predictions, on every process
        preds["test"] = preds["test"].gather()
    synchronize(device)
    t_end = time.perf_counter()

    ev = observe_events.active()
    if ev is not None:
        for phase, wall in (
            ("load", t_load - t0),
            ("featurize", t_feat - t_load),
            ("fit", t_fit - t_feat),
            ("eval", t_end - t_fit),
        ):
            ev.emit("phase", phase=phase, wall_s=wall)
        try:
            _record_observability(ev, bank, model, test_x, device)
        except Exception as e:  # noqa: BLE001 — observability must not
            # fail a pipeline run that already trained and evaluated
            logger.warning("observability recording failed: %r", e)

    result = {
        "train_error": errors["train"],
        "test_error": errors["test"],
        "n_train": n_train,
        "n_test": n_test,
        "device": str(device),
        "processes": multihost.process_count() if dp else 1,
        "load_s": t_load - t0,
        "featurize_s": t_feat - t_load,
        "fit_s": t_fit - t_feat,
        "total_s": t_end - t0,
        "train_samples_per_s": n_train / (t_fit - t_load),
        "test_predictions": preds["test"].cpu().numpy(),
    }
    if fit_plan is not None:
        result["fit_decisions"] = fit_plan.decisions
        result["fit_chunk_size"] = fit_plan.chunk_size
        result["apply_decisions"] = apply_decisions
    logger.info(
        "MnistRandomFFT: train err %.2f%%, test err %.2f%%, "
        "featurize+fit %.1f samples/s",
        100 * result["train_error"],
        100 * result["test_error"],
        result["train_samples_per_s"],
    )
    return result


def _rows_of(n: int, mesh) -> tuple[int, int]:
    """This process's rows of an ``n``-row split: all of them without a
    mesh across processes, else the row block of its data position."""
    if mesh is None:
        return 0, n
    lo, hi = multihost.row_block(n, local_position(mesh), data_axis_size(mesh))
    return min(lo, n), min(hi, n)


def _record_observability(ev, bank, model, test_x, device) -> None:
    """Per-node wall-time events and cost profiles for the fitted apply
    pipeline (featurizer bank → block model → argmax), recorded on a
    bounded probe so observability costs a small constant: the
    KeystoneML operator-profile sample for this pipeline."""
    from keystone_tpu_torch.observe.cost import record_pipeline_profile

    pipe = Pipeline.of(bank, model, MaxClassifier())
    probe = test_x[: min(2048, test_x.shape[0])].to(device)
    record_pipeline_profile(pipe, probe, save_dir=ev.run_dir)


def main(argv=None, device=None, mesh=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card).
    ``mesh`` is :func:`run`'s (default: every process of a group on the
    data axis)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(MnistRandomFFTConfig, rest)
    if not conf.synthetic and not (conf.train_location and conf.test_location):
        raise SystemExit("need --train-location AND --test-location, or --synthetic N")
    return run(conf, device=device if device is not None else known.device, mesh=mesh)


if __name__ == "__main__":
    main()
