"""Ridge-path model selection over a λ sweep — port of
``keystone_tpu/evaluation/model_selection.py``.

:meth:`BlockLeastSquaresEstimator.fit_sweep` fits one model per λ on
shared Grams; :func:`select_lambda` scores each on held-out rows and
returns the winner, and :func:`holdout_lambda_sweep` is the wiring behind
the model CLIs' ``--lam-sweep`` flag.
"""

from __future__ import annotations

import numpy as np

from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.ops.util import MaxClassifier


def select_lambda(
    est,
    train_inputs,
    train_indicators,
    lams,
    val_inputs,
    val_label_idx,
    *,
    num_classes: int,
    n_valid: int | None = None,
    n_valid_val: int | None = None,
):
    """Fit one model per λ (shared Grams) and pick the best by held-out
    multiclass error. Returns ``(best_model, report)``, the report listing
    the per-λ errors."""
    models = est.fit_sweep(train_inputs, train_indicators, lams, n_valid=n_valid)
    classify = MaxClassifier()
    evaluator = MulticlassClassifierEvaluator(num_classes)
    errors = [
        float(evaluator(classify(m(val_inputs)), val_label_idx, n_valid=n_valid_val).error)
        for m in models
    ]
    best, report = _pick_best(lams, errors)
    return models[best], report


def _pick_best(lams, losses):
    """argmin selection and the report dict every sweep path returns."""
    best = int(np.argmin(losses))
    return best, {
        "lams": [float(l) for l in lams],
        "val_errors": [float(e) for e in losses],
        "best_lam": float(lams[best]),
        "best_error": float(losses[best]),
    }


def holdout_lambda_sweep(
    est,
    train_inputs,
    train_indicators,
    train_label_idx,
    lams,
    *,
    n_train: int,
    num_classes: int | None = None,
    holdout_frac: float = 0.1,
    scorer=None,
):
    """λ selection on a held-out suffix of the training rows: the sweep is
    fitted on the first ``1 − holdout_frac`` of the ``n_train`` valid rows
    and each λ scored on the rest. Returns the report dict (``best_lam``,
    per-λ ``val_errors``); callers refit at ``best_lam``. ``lams`` may be
    the raw comma-separated flag string or a sequence of floats.

    Default scoring is multiclass error on ``train_label_idx`` (needs
    ``num_classes``); ``scorer(model, val_inputs, (lo, hi)) -> loss``
    (lower is better; ``lo:hi`` the held-out row range) replaces it."""
    if isinstance(lams, str):
        lams = [float(x) for x in lams.split(",") if x.strip()]
    lams = list(lams)
    if not lams:
        raise ValueError(
            'lambda sweep got no values — pass e.g. --lam-sweep "1e-3,1e-2,1e-1"'
        )
    n_hold = int(n_train * holdout_frac)
    if n_hold < 1:
        raise ValueError(
            f"lambda sweep holdout is empty: n_train={n_train} at "
            f"holdout_frac={holdout_frac} leaves no validation rows"
        )
    n_fit = n_train - n_hold
    if isinstance(train_inputs, (list, tuple)):
        val_inputs = [b[n_fit:] for b in train_inputs]
        pad_rows = val_inputs[0].shape[0]
    else:
        val_inputs = train_inputs[n_fit:]
        pad_rows = val_inputs.shape[0]
    if scorer is not None:
        models = est.fit_sweep(train_inputs, train_indicators, lams, n_valid=n_fit)
        losses = [float(scorer(m, val_inputs, (n_fit, n_train))) for m in models]
        return _pick_best(lams, losses)[1]
    if num_classes is None:
        raise ValueError("num_classes is required for the default scorer")
    val_y = np.asarray(train_label_idx[n_fit:n_train], np.int32)
    _, report = select_lambda(
        est,
        train_inputs,
        train_indicators,
        lams,
        val_inputs,
        np.pad(val_y, (0, pad_rows - len(val_y))),
        num_classes=num_classes,
        n_valid=n_fit,
        n_valid_val=len(val_y),
    )
    return report
