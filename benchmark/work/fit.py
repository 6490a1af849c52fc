"""Work that the MNIST random-FFT fit needs, counted from its shapes and
the configuration, whatever the program runs to do it.

- The featurizer: per row and draw, a sign flip of ``d`` values and a
  real FFT of the row zero-padded to ``n = next_pow2(d)`` points, counted
  as ``2.5 n log2 n`` flops (half a complex FFT's ``5 n log2 n``), and a
  rectifier over the ``n / 2`` kept values.
- The Gram: ``N D (D + 1)`` int8 operations (a multiply and an add for
  every entry of the upper triangle and the diagonal, over ``N`` rows),
  and the cross product ``Aᵀ B``: ``2 N D K`` flops.
- The solve: one block-coordinate pass over ``D / b`` blocks of width
  ``b``; per block a Cholesky factor (``b³ / 3``), the right-hand side
  (``2 b D K``) and two triangular solves (``2 b² K``).
"""

from __future__ import annotations

import math


def next_pow2(d: int) -> int:
    return 1 << max(int(math.ceil(math.log2(d))), 0) if d > 1 else 1


def features(config: dict) -> int:
    """D: ``numFFTs`` draws of ``next_pow2(d) / 2`` features each."""
    return config["numFFTs"] * (next_pow2(config["image_dim"]) // 2)


def featurize_flops(rows: int, config: dict) -> float:
    d = config["image_dim"]
    n = next_pow2(d)
    per_draw = d + 2.5 * n * math.log2(n) + n / 2
    return float(rows) * config["numFFTs"] * per_draw


def gram_ops(rows: int, dim: int) -> float:
    return float(rows) * dim * (dim + 1)


def gram_bytes(rows: int, dim: int) -> float:
    """One K1 call: the int8 codes read once, the f32 Gram written once."""
    return float(rows) * dim + 4.0 * dim * dim


def cross_flops(rows: int, dim: int, k: int) -> float:
    return 2.0 * rows * dim * k


def solve_flops(dim: int, k: int, block: int, passes: int = 1) -> float:
    total = 0.0
    for s in range(0, dim, block):
        b = min(block, dim - s)
        total += b**3 / 3.0 + 2.0 * b * dim * k + 2.0 * b * b * k
    return passes * total


def fit_stage_seconds(config: dict, peaks) -> dict:
    """Each stage's least time for one whole fit, at the peak of the
    dtype the configuration states for it."""
    n, k = config["num_train"], config["num_classes"]
    dim = features(config)
    gram_dtype = config["gram_op"]
    solve = config["solve_dtype"]
    return {
        "featurize": featurize_flops(n, config) / peaks.PEAK_FLOPS[config["featurize_dtype"]],
        "gram": gram_ops(n, dim) / peaks.PEAK_FLOPS[gram_dtype],
        "cross": cross_flops(n, dim, k) / peaks.PEAK_FLOPS[solve],
        "solve": solve_flops(dim, k, config["blockSize"], config["solver_passes"])
        / peaks.PEAK_FLOPS[solve],
    }
