"""Linear models, block least squares and the streaming normal equations.

Port of ``keystone_tpu/ops/linear.py``:

- the stabilized ridge solve: Jacobi equilibration, an escalating jitter
  (×32 until the Cholesky factor is finite) and two steps of iterative
  refinement against the original system, and
  :func:`stabilized_cho_solve`, its factor-once multi-RHS form;
- :class:`LinearMapper` and :class:`LinearMapEstimator`, the exact ridge
  fit on centered normal equations, one model or a λ sweep;
- the streaming normal-equations protocol: a running centered
  (AᵀA, AᵀB, μa, μb, n) f32 state folded chunk by chunk with Chan's
  pairwise merge, with a ``gram_fn`` hook that swaps the AᵀA operator
  (e.g. the int8 Gram, :func:`keystone_tpu_torch.ops.gram.ata_int8`);
- :class:`BlockLinearMapper` and :class:`BlockLeastSquaresEstimator`
  with the data-form BCD fit (:func:`_bcd_fit`), its λ sweep on shared
  Grams (:func:`_bcd_fit_sweep`) and the Gram-form fit behind the
  ``fit_stats_*`` protocol (:func:`_bcd_fit_gram`, one model per λ);
- :class:`LeastSquaresEstimator`, which picks between the two by width.

Everything runs on the tensors' device. Padded rows are masked with
``n_valid``. Where the reference vmaps over λ, the port loops over it: the
solves are small next to the shared Grams.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Callable

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import LabelEstimator, Transformer
from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.ops.stats import StandardScalerModel


def _row_mask(n_rows: int, n_valid, dtype, device) -> torch.Tensor:
    """(n_rows, 1) mask of valid rows; all-ones when n_valid is None."""
    if n_valid is None:
        return torch.ones((n_rows, 1), dtype=dtype, device=device)
    return (torch.arange(n_rows, device=device) < n_valid)[:, None].to(dtype)


def _cholesky_or_nan(m: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of ``m`` (leading axes batch);
    all-NaN where a matrix is not positive definite (the failure signal
    the JAX reference's factor gives)."""
    c, info = torch.linalg.cholesky_ex(m)
    return torch.where((info != 0)[..., None, None], float("nan"), c)


def _cho_factor_escalating(m: torch.Tensor, jitter: float, max_steps: int = 5):
    """Cholesky with an escalating jitter floor: factor ``m + j·I``,
    multiplying ``j`` by 32 until the factor is NaN-free (rank-deficient
    Grams can be INDEFINITE at the f32 noise level). Leading axes of ``m``
    batch: each matrix escalates on its own, as the reference's vmapped
    while loop does. Returns the (lower factor, jitter used) pair, the
    jitter a float for one matrix and a tensor for a batch."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    j = torch.full(m.shape[:-2], jitter, dtype=m.dtype, device=m.device)
    c = _cholesky_or_nan(m + jitter * eye)
    for _ in range(max_steps):
        bad = torch.isnan(c).flatten(-2).any(-1)
        if not bool(bad.any()):
            break
        if m.ndim == 2:
            j = j * 32.0
            c = _cholesky_or_nan(m + j * eye)
            continue
        idx = bad.nonzero(as_tuple=True)
        j[idx] *= 32.0
        c[idx] = _cholesky_or_nan(m[idx] + j[idx][..., None, None] * eye)
    return c, (float(j) if m.ndim == 2 else j)


def ridge_factor(ata: torch.Tensor, lam, jitter: float = 1e-6):
    """Equilibrated escalating-jitter Cholesky of ``AᵀA + λI`` as
    ``(lower factor, inv_s)`` — hoisted out of BCD's pass loop. Leading
    axes of ``ata`` batch (one factor per matrix)."""
    inv_s = torch.rsqrt(torch.clamp_min(torch.diagonal(ata, dim1=-2, dim2=-1), 1e-30))
    m = ata * (inv_s[..., :, None] * inv_s[..., None, :])
    m = m + torch.diag_embed(lam * inv_s * inv_s)
    c, _ = _cho_factor_escalating(m, jitter)
    return c, inv_s


def ridge_solve_prefactored(factor, ata, atb, lam, refine: int = 2):
    """Solve with a :func:`ridge_factor` result; refinement targets the
    ORIGINAL system, recovering what the equilibrated/jittered factor
    loses. Batched factors take batched ``ata`` and ``atb``."""
    c, inv_s = factor

    def solve_prec(rhs):
        return inv_s[..., :, None] * torch.cholesky_solve(rhs * inv_s[..., :, None], c)

    x = solve_prec(atb)
    for _ in range(refine):
        r = atb - (ata @ x + lam * x)
        x = x + solve_prec(r)
    return x


def ridge_solve(ata, atb, lam, refine: int = 2, jitter: float = 1e-6):
    """Solve ``(AᵀA + λI) X = AᵀB`` — the NormalEquations primitive, in
    f32, stabilized by equilibration, escalating jitter and refinement."""
    return ridge_solve_prefactored(
        ridge_factor(ata, lam, jitter), ata, atb, lam, refine
    )


ENV_MATMUL_PRECISION = "KEYSTONE_MATMUL_PRECISION"

# KEYSTONE_MATMUL_PRECISION names (JAX's) → torch float32 matmul precision
_PRECISIONS = {
    "highest": "highest",
    "float32": "highest",
    "high": "high",
    "tensorfloat32": "high",
    "bfloat16_3x": "high",
    "default": "medium",
    "bfloat16": "medium",
    "fastest": "medium",
}


# the float32 flags a precision scope sets are process-wide: one scope at
# a time, so two threads' scopes (a MicroBatcher's and an
# ExportedApply's) cannot interleave their sets and restores
_FP32_FLAGS_LOCK = threading.RLock()


def _fp32_flag_plan(level: str) -> list:
    """((backend, op), value) for every process-wide float32 precision
    flag, in the order to set them, for ``level`` (``highest``/``high``/
    ``medium``): the generic flag and the CUDA and oneDNN backend flags
    first, set to ``none``, because setting a parent writes its value into
    every operator under it; then each operator the CPU and CUDA paths
    read. ``highest`` is IEEE float32 everywhere. A lower level lets
    cuBLAS and cuDNN take TF32 and oneDNN's matmul TF32 (``high``) or bf16
    (``medium``), as ``torch.set_float32_matmul_precision`` does; oneDNN's
    convolution stays IEEE."""
    cuda = "ieee" if level == "highest" else "tf32"
    onednn_matmul = {"highest": "ieee", "high": "tf32", "medium": "bf16"}[level]
    return [
        (("generic", "all"), "none"),
        (("cuda", "all"), "none"),
        (("mkldnn", "all"), "none"),
        (("cuda", "matmul"), cuda),
        (("cuda", "conv"), cuda),
        (("cuda", "rnn"), cuda),
        (("mkldnn", "matmul"), onednn_matmul),
        (("mkldnn", "conv"), "ieee"),
        (("mkldnn", "rnn"), "ieee"),
    ]


@contextlib.contextmanager
def _matmul_precision(precision: str | None):
    """Scope the float32 precision of products and convolutions.

    ``precision=None`` falls back to the ``KEYSTONE_MATMUL_PRECISION`` env
    knob, and to full f32 when that too is unset. ``highest``/``float32``
    → full f32, ``high``/``tensorfloat32``/``bfloat16_3x`` → TF32,
    ``default``/``bfloat16``/``fastest`` → bf16 passes on oneDNN (TF32 on
    the card), as ``torch.set_float32_matmul_precision`` maps them.

    The scope sets every process-wide flag that cuBLAS, cuDNN and oneDNN
    read (:func:`_fp32_flag_plan`), whatever state the process was left
    in, and puts each back afterwards. It reads and writes them by
    (backend, op) through the one accessor pair behind ``torch.backends``'
    ``fp32_precision`` attributes, whose reads never raise (the legacy
    getters raise once the two APIs were mixed). It holds a lock."""
    name = precision or os.environ.get(ENV_MATMUL_PRECISION, "").strip() or "highest"
    if name.lower() not in _PRECISIONS:
        raise ValueError(f"unknown matmul precision {name!r}")
    level = _PRECISIONS[name.lower()]
    plan = _fp32_flag_plan(level)
    get, put = torch._C._get_fp32_precision_getter, torch._C._set_fp32_precision_setter
    # torch's ``ieee`` leaves oneDNN's own default math mode in place,
    # which its env variable can lower to bf16 for the whole process: a
    # full-f32 scope then keeps oneDNN out (the CPU convolution falls
    # back to im2col on the f32 BLAS)
    no_onednn = level == "highest" and _onednn_default_lowered()
    with _FP32_FLAGS_LOCK:
        saved = [(flag, get(*flag)) for flag, _ in plan]
        mkldnn_was = torch._C._get_mkldnn_enabled()
        try:
            for flag, value in plan:
                put(*flag, value)
            if no_onednn:
                torch._C._set_mkldnn_enabled(False)
            yield
        finally:
            torch._C._set_mkldnn_enabled(mkldnn_was)
            for flag, value in saved:
                put(*flag, value)


def _onednn_default_lowered() -> bool:
    """True when oneDNN's process-wide default float32 math mode is set
    below IEEE (``ONEDNN_DEFAULT_FPMATH_MODE`` / ``DNNL_…``, read by
    oneDNN at its first primitive)."""
    for var in ("ONEDNN_DEFAULT_FPMATH_MODE", "DNNL_DEFAULT_FPMATH_MODE"):
        mode = os.environ.get(var, "").strip().upper()
        if mode and mode != "STRICT":
            return True
    return False


def stabilized_cho_solve(mat: torch.Tensor, jitter: float = 1e-6):
    """Factor a symmetric PSD ``mat`` once (equilibrated, escalating
    jitter, as :func:`ridge_solve`) and return a solver mapping a (d, k)
    right-hand side to (d, k)."""
    c, inv_s = ridge_factor(mat, 0.0, jitter)

    def solve(rhs):
        return inv_s[:, None] * torch.cholesky_solve(rhs * inv_s[:, None], c)

    return solve


@dataclasses.dataclass(eq=False)
class LinearMapper(Transformer):
    """``in @ x + b``, with an optional feature scaler applied first."""

    x: torch.Tensor  # (D, K)
    b: torch.Tensor | None = None
    feature_scaler: StandardScalerModel | None = None

    def __call__(self, batch):
        if self.feature_scaler is not None:
            batch = self.feature_scaler(batch)
        out = batch @ self.x
        if self.b is not None:
            out = out + self.b
        return out


def _centered_mapper(x, b_mean, a_mean) -> LinearMapper:
    return LinearMapper(x=x, b=b_mean, feature_scaler=StandardScalerModel(mean=a_mean))


@dataclasses.dataclass(eq=False)
class LinearMapEstimator(LabelEstimator):
    """Exact ridge/OLS by the normal equations on mean-centered A and b;
    the model carries the feature mean as its scaler and the label mean
    as its intercept."""

    fits_global_rows = True

    lam: float = 0.0

    def fit(self, data, labels, n_valid: int | None = None) -> LinearMapper:
        """A :class:`~keystone_tpu_torch.parallel.multihost.GlobalRows`
        ``data`` fits the global batch (:func:`_global_stats`)."""
        if _is_global(data):
            return self.fit_stats_finalize(_global_stats(data, labels, None))
        with _matmul_precision(None):
            x, b_mean, a_mean = _linear_map_fit(data, labels, n_valid, self.lam)
        return _centered_mapper(x, b_mean, a_mean)

    def fit_sweep(self, data, labels, lams, n_valid: int | None = None) -> list:
        """One exact ridge model per λ from one Gram."""
        if _is_global(data):
            return self.fit_sweep_finalize(_global_stats(data, labels, None), lams)
        with _matmul_precision(None):
            xs, b_mean, a_mean = _linear_map_fit_sweep(data, labels, n_valid, lams)
        return [_centered_mapper(x, b_mean, a_mean) for x in xs]

    # -- streaming normal-equations protocol (fit_stats_*) ---------------

    def fit_stats_init(self, d: int, k: int, device=None) -> "NormalEqState":
        return normal_eq_init(d, k, device)

    def fit_stats_update(self, state, data, labels, n_valid=None, gram_fn=None):
        return normal_eq_update(state, data, labels, n_valid, gram_fn)

    def fit_stats_finalize(self, state, widths=None) -> LinearMapper:
        ata, atb, b_mean, a_mean, _ = normal_eq_finalize(state)
        with _matmul_precision(None):
            x = _ridge_from_stats(ata, atb, self.lam)
        return _centered_mapper(x, b_mean, a_mean)

    def fit_sweep_finalize(self, state, lams, widths=None) -> list:
        """The λ sweep off one accumulated state."""
        ata, atb, b_mean, a_mean, _ = normal_eq_finalize(state)
        with _matmul_precision(None):
            xs = _ridge_sweep_from_stats(ata, atb, lams)
        return [_centered_mapper(x, b_mean, a_mean) for x in xs]

    @staticmethod
    def fit_stats_flops_per_row(d: int, k: int) -> float:
        return 2.0 * d * (d + k)

    @staticmethod
    def fit_stats_state_bytes(d: int, k: int) -> int:
        return 4 * (d * d + d * k + 2 * d + 2 * k)


def _is_global(data) -> bool:
    from keystone_tpu_torch.parallel.multihost import GlobalRows

    return isinstance(data, GlobalRows)


def _global_stats(data, labels, precision: str | None) -> "NormalEqState":
    """The normal-equation statistics of a global batch: this process's
    valid rows folded into a state, then every process's state merged in
    rank order over the process group (the reference's GSPMD turns each
    row contraction into a psum instead). ``labels`` is a ``GlobalRows``
    of the same layout or this process's label rows. The merge runs over
    ``data.group``: on a mesh with a model axis each data row counts
    once."""
    from keystone_tpu_torch.learn.merge import merge_over_group

    local = _concat_blocks(data.local)
    lab = labels.local if _is_global(labels) else labels
    state = normal_eq_init(local.shape[-1], lab.shape[-1], local.device)
    state = normal_eq_update(state, local, lab, data.n_valid, precision=precision)
    return merge_over_group(state, data.group)


def _normal_eq_stats(data, labels, n_valid):
    """Masked means, centered AᵀA and AᵀB."""
    mask = _row_mask(data.shape[0], n_valid, data.dtype, data.device)
    n = mask.sum()
    a_mean = (data * mask).sum(0) / n
    b_mean = (labels * mask).sum(0) / n
    a_c = (data - a_mean) * mask
    b_c = (labels - b_mean) * mask
    return a_c.T @ a_c, a_c.T @ b_c, b_mean, a_mean


def _linear_map_fit(data, labels, n_valid, lam: float):
    ata, atb, b_mean, a_mean = _normal_eq_stats(data, labels, n_valid)
    return ridge_solve(ata, atb, lam), b_mean, a_mean


def _linear_map_fit_sweep(data, labels, n_valid, lams):
    ata, atb, b_mean, a_mean = _normal_eq_stats(data, labels, n_valid)
    return _ridge_sweep_from_stats(ata, atb, lams), b_mean, a_mean


def _ridge_from_stats(ata, atb, lam: float):
    return ridge_solve(ata, atb, lam)


def _ridge_sweep_from_stats(ata, atb, lams) -> torch.Tensor:
    """(L, D, K): one ridge solve per λ."""
    return torch.stack([ridge_solve(ata, atb, float(lam)) for lam in lams])


# ---------------------------------------------------------------------------
# Streaming normal equations: chunk-accumulated (AᵀA, AᵀB, μa, μb, n) state
# in f32 — each chunk centered about its own mean, merged with a rank-1
# mean-difference correction (Chan's pairwise update), so the centered Gram
# needs no finalize-time subtraction.


@dataclasses.dataclass(eq=False)
class NormalEqState:
    """Running f32 normal-equation statistics over streamed chunks; the
    Gram stays CENTERED about the running mean throughout."""

    ata: torch.Tensor  # (D, D) centered Σ about the running mean
    atb: torch.Tensor  # (D, K) centered cross product
    mean_a: torch.Tensor  # (D,) running masked mean of the features
    mean_b: torch.Tensor  # (K,) running masked mean of the labels
    n: torch.Tensor  # () valid-row count


def normal_eq_init(d: int, k: int, device=None) -> NormalEqState:
    """Zero state for a (N, d) → (N, k) streamed fit, on ``device``: the
    card unless the caller asks for the CPU."""
    f32 = torch.float32
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    return NormalEqState(ata=z(d, d), atb=z(d, k), mean_a=z(d), mean_b=z(k), n=z())


def _concat_blocks(data):
    if isinstance(data, (list, tuple)):
        return torch.cat(list(data), dim=-1)
    return data


def _normal_eq_update(state, data, labels, n_valid, gram_fn):
    data = _concat_blocks(data)
    f32 = torch.float32
    mask = _row_mask(data.shape[0], n_valid, f32, data.device)
    m = mask.sum()
    m_safe = torch.clamp_min(m, 1.0)
    a = data.to(f32)
    b = labels.to(f32)
    mu_a = (a * mask).sum(0) / m_safe
    mu_b = (b * mask).sum(0) / m_safe
    a_c = (a - mu_a) * mask
    b_c = (b - mu_b) * mask
    gram = gram_fn(a_c) if gram_fn is not None else a_c.T @ a_c
    # Chan merge: an all-pad chunk (m = 0) contributes nothing — the rank-1
    # weight n·m/(n+m) and the mean step m/(n+m) both vanish
    n_new = torch.clamp_min(state.n + m, 1.0)
    w = state.n * m / n_new
    da = mu_a - state.mean_a
    db = mu_b - state.mean_b
    # the state is never mutated; the rank-1 terms are added in place to
    # the fresh sums so a (D, D) update holds one extra (D, D) temporary
    ata = state.ata + gram
    del gram
    ata.add_(torch.outer(da, da).mul_(w))
    atb = (state.atb + a_c.T @ b_c).add_(torch.outer(da, db).mul_(w))
    return NormalEqState(
        ata=ata,
        atb=atb,
        mean_a=state.mean_a + (m / n_new) * da,
        mean_b=state.mean_b + (m / n_new) * db,
        n=state.n + m,
    )


def normal_eq_update(
    state: NormalEqState,
    data,
    labels,
    n_valid=None,
    gram_fn: Callable | None = None,
    precision: str | None = None,
) -> NormalEqState:
    """Fold one chunk into the state. ``data`` may be a (rows, d) tensor
    or a list of feature blocks (concatenated); ``n_valid`` masks trailing
    pad rows out of every statistic; ``gram_fn`` swaps the AᵀA operator —
    it maps a centered, masked (rows, d) chunk to a (d, d) f32 Gram;
    ``precision`` pins the matmul precision (falls back to
    ``KEYSTONE_MATMUL_PRECISION``)."""
    with _matmul_precision(precision):
        return _normal_eq_update(state, data, labels, n_valid, gram_fn)


def normal_eq_finalize(state: NormalEqState):
    """Centered ``(AᵀA, AᵀB, b_mean, a_mean, n)`` — a plain read."""
    n = torch.clamp_min(state.n, 1.0)
    return state.ata, state.atb, state.mean_b, state.mean_a, n


def block_widths(d: int, block_size: int) -> tuple[int, ...]:
    """THE one home of feature-block boundaries (last block may be
    narrower)."""
    return tuple(min(block_size, d - s) for s in range(0, max(d, 1), block_size))


def split_by_widths(data, widths) -> list:
    """Slice the feature axis by explicit block widths."""
    blocks, start = [], 0
    for w in widths:
        blocks.append(data[..., start : start + w])
        start += w
    return blocks


def _split_blocks(data, block_size: int) -> list:
    if isinstance(data, (list, tuple)):
        return list(data)
    return split_by_widths(data, block_widths(data.shape[-1], block_size))


@dataclasses.dataclass(eq=False)
class BlockLinearMapper(Transformer):
    """Linear model stored as column blocks of the feature axis;
    ``apply`` sums per-block partial products. Accepts the full (N, D)
    tensor or a pre-split block list."""

    xs: tuple  # per-block (d_i, K) weights
    b: torch.Tensor | None = None
    means: tuple | None = None  # per-block feature means (centering)
    block_size: int = 4096

    def _blocks_of(self, batch) -> list:
        if isinstance(batch, (list, tuple)):
            return list(batch)
        return split_by_widths(batch, tuple(x.shape[0] for x in self.xs))

    def __call__(self, batch):
        blocks = self._blocks_of(batch)
        out = self._partial(blocks[0], 0)
        for i in range(1, len(blocks)):
            out = out + self._partial(blocks[i], i)
        if self.b is not None:
            out = out + self.b
        return out

    def _partial(self, block, i):
        if self.means is not None:
            block = block - self.means[i]
        return block @ self.xs[i]

    def apply_and_evaluate(self, batch, evaluator: Callable[[torch.Tensor], None]):
        """Stream per-block partial predictions to ``evaluator`` as blocks
        accumulate."""
        acc = None
        for i, blk in enumerate(self._blocks_of(batch)):
            p = self._partial(blk, i)
            acc = p if acc is None else acc + p
            evaluator(acc if self.b is None else acc + self.b)


@dataclasses.dataclass(eq=False)
class BlockLeastSquaresEstimator(LabelEstimator):
    """Block coordinate descent least squares with L2 regularization:
    labels centered by their mean, each feature block mean-centered,
    ``num_iter`` BCD passes over the blocks with ridge ``lam``; the fitted
    model carries per-block means and the label-mean intercept.

    ``precision`` pins the Gram/solve matmul precision (see
    :func:`_matmul_precision`); ``None`` follows the env knob."""

    fits_global_rows = True

    block_size: int = 4096
    num_iter: int = 1
    lam: float = 0.0
    precision: str | None = None

    def fit(
        self, data, labels, n_valid: int | None = None, init: BlockLinearMapper | None = None
    ) -> BlockLinearMapper:
        """``init`` warm-starts BCD from a fitted model's blocks: the fixed
        point is the same, and k passes from a model checkpointed after j
        passes continue the (j+k)-pass fit (see
        :func:`keystone_tpu_torch.core.checkpoint.resumable_fit`)."""
        if _is_global(data):
            return self._fit_global(data, labels, [self.lam], init)[0]
        blocks = _split_blocks(data, self.block_size)
        init_xs = None if init is None else tuple(init.xs)
        with _matmul_precision(self.precision):
            xs, means, intercept = _bcd_fit(
                tuple(blocks), labels, n_valid, self.num_iter, self.lam, init_xs
            )
        return BlockLinearMapper(
            xs=xs, b=intercept, means=means, block_size=self.block_size
        )

    def fit_sweep(
        self, data, labels, lams, n_valid: int | None = None, sweep_chunk: int | None = None
    ) -> list:
        """One model per ridge λ in ``lams``, in order, at marginal cost:
        the per-block Grams (the N·d² work) are shared and the solves and
        residuals are batched over the sweep. The (L, N, K) residual and
        the per-(block, λ) factors grow with L, so ``sweep_chunk`` runs a
        few λ at a time (the Grams are recomputed per chunk); ``None``
        sizes chunks to keep those under about 2 GiB."""
        if _is_global(data):
            return self._fit_global(data, labels, [float(lam) for lam in lams])
        blocks = _split_blocks(data, self.block_size)
        lams = [float(lam) for lam in lams]
        if sweep_chunk is None:
            # per λ: the residual slice and the factors of every block
            per_lam = (
                blocks[0].shape[0] * labels.shape[-1] + sum(b.shape[-1] ** 2 for b in blocks)
            ) * blocks[0].element_size()
            sweep_chunk = max(1, min(len(lams), (2 << 30) // max(per_lam, 1)))
        models: list[BlockLinearMapper] = []
        with _matmul_precision(self.precision):
            for s in range(0, len(lams), sweep_chunk):
                xs_l, means, intercept = _bcd_fit_sweep(
                    tuple(blocks), labels, n_valid, lams[s : s + sweep_chunk], self.num_iter
                )
                models.extend(
                    BlockLinearMapper(
                        xs=tuple(xb[i] for xb in xs_l),
                        b=intercept,
                        means=means,
                        block_size=self.block_size,
                    )
                    for i in range(xs_l[0].shape[0])
                )
        return models

    # -- streaming normal-equations protocol (fit_stats_*) ---------------

    def fit_stats_init(self, d: int, k: int, device=None) -> NormalEqState:
        return normal_eq_init(d, k, device)

    def fit_stats_update(
        self, state, data, labels, n_valid=None, gram_fn=None
    ) -> NormalEqState:
        return normal_eq_update(
            state, data, labels, n_valid, gram_fn, precision=self.precision
        )

    def _finalize_widths(self, state, widths) -> tuple[int, ...]:
        d = state.ata.shape[0]
        return tuple(widths) if widths else block_widths(d, self.block_size)

    def fit_stats_finalize(self, state, widths=None) -> BlockLinearMapper:
        """``widths`` pins the block boundaries to the caller's feature
        blocks; default derives them from :func:`block_widths`."""
        return self.fit_sweep_finalize(state, [self.lam], widths=widths)[0]

    def fit_sweep_finalize(self, state, lams, widths=None) -> list:
        """One model per λ in ``lams`` off one accumulated state."""
        return self._finalize(state, lams, widths)

    def _fit_global(self, data, labels, lams, init=None) -> list:
        """A global batch (``GlobalRows``): the Gram form of the same BCD
        fixed point, over the statistics of every process's rows."""
        widths = (tuple(b.shape[-1] for b in data.local)
                  if isinstance(data.local, (list, tuple)) else None)
        init_x = None if init is None else torch.cat(list(init.xs), dim=0)
        return self._finalize(_global_stats(data, labels, self.precision), lams, widths, init_x)

    def _finalize(self, state, lams, widths, init_x=None) -> list:
        widths = self._finalize_widths(state, widths)
        ata, atb, b_mean, a_mean, _ = normal_eq_finalize(state)
        with _matmul_precision(self.precision):
            xs_l = _bcd_fit_gram(ata, atb, lams, widths, self.num_iter, init_x)
        means = tuple(split_by_widths(a_mean, widths))
        offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)
        return [
            BlockLinearMapper(
                xs=tuple(x[offs[j] : offs[j + 1]] for j in range(len(widths))),
                b=b_mean,
                means=means,
                block_size=self.block_size,
            )
            for x in xs_l
        ]

    @staticmethod
    def fit_stats_flops_per_row(d: int, k: int) -> float:
        return 2.0 * d * (d + k)

    @staticmethod
    def fit_stats_state_bytes(d: int, k: int) -> int:
        return 4 * (d * d + d * k + 2 * d + 2 * k)


def _block_stats(blocks: tuple, labels, n_valid):
    """Shared BCD preamble: row mask, label mean, per-block means,
    centered blocks and Grams."""
    dtype = blocks[0].dtype
    mask = _row_mask(blocks[0].shape[0], n_valid, dtype, blocks[0].device)
    n = mask.sum()
    b_mean = (labels * mask).sum(0) / n
    means, centered, grams = [], [], []
    for blk in blocks:
        m = (blk * mask).sum(0) / n
        a_c = (blk - m) * mask
        means.append(m)
        centered.append(a_c)
        grams.append(a_c.T @ a_c)
    return mask, b_mean, means, centered, grams


def _bcd_fit(blocks: tuple, labels, n_valid, num_iter: int, lam: float, init_xs=None):
    """Data-form BCD: per-block Grams and factors computed once, the
    residual carried across blocks and passes. ``init_xs`` warm-starts
    the blocks; the residual is then recomputed from them."""
    dtype = blocks[0].dtype
    mask, b_mean, means, centered, grams = _block_stats(blocks, labels, n_valid)
    k = labels.shape[-1]
    if init_xs is None:
        xs = [torch.zeros((blk.shape[-1], k), dtype=dtype, device=blk.device) for blk in blocks]
    else:
        xs = [x.to(dtype=dtype, device=blk.device) for x, blk in zip(init_xs, blocks)]
    resid = (labels - b_mean) * mask
    if init_xs is not None:
        # the residual consistent with the warm start: R = b_c − Σ A_i x_i
        for a_c, x in zip(centered, xs):
            resid = resid - a_c @ x
    factors = [ridge_factor(g, lam) for g in grams]
    for _ in range(num_iter):
        for i, a_c in enumerate(centered):
            rhs = a_c.T @ resid + grams[i] @ xs[i]
            x_new = ridge_solve_prefactored(factors[i], grams[i], rhs, lam)
            resid = resid - a_c @ (x_new - xs[i])
            xs[i] = x_new
    return tuple(xs), tuple(means), b_mean


def _bcd_fit_sweep(blocks: tuple, labels, n_valid, lams, num_iter: int):
    """Multi-λ data-form BCD: Grams shared over the sweep, each λ's
    factors computed once, solves and residuals batched over λ. Returns
    per-block weights with a leading sweep axis (L, d_block, K)."""
    dtype = blocks[0].dtype
    mask, b_mean, means, centered, grams = _block_stats(blocks, labels, n_valid)
    k, n_lam = labels.shape[-1], len(lams)
    xs = [torch.zeros((n_lam, blk.shape[-1], k), dtype=dtype, device=blk.device) for blk in blocks]
    resid = ((labels - b_mean) * mask).expand(n_lam, -1, -1).to(dtype)
    factors = [[ridge_factor(g, lam) for lam in lams] for g in grams]
    for _ in range(num_iter):
        for i, a_c in enumerate(centered):
            rhs = torch.einsum("nd,lnc->ldc", a_c, resid) + grams[i] @ xs[i]
            x_new = torch.stack([
                ridge_solve_prefactored(factors[i][j], grams[i], rhs[j], lam)
                for j, lam in enumerate(lams)
            ])
            resid = resid - torch.einsum("nd,ldc->lnc", a_c, x_new - xs[i])
            xs[i] = x_new
    return tuple(xs), tuple(means), b_mean


def _bcd_fit_gram(ata, atb, lams, widths: tuple, num_iter: int, init_x=None) -> torch.Tensor:
    """Gram-form BCD: the same fixed point as :func:`_bcd_fit`, from the
    FULL centered normal-equation statistics. The data-form block update
    ``rhs_i = A_iᵀR + G_ii x_i`` becomes ``(AᵀB)_i − G[i,:] x + G_ii x_i``,
    so the pass loop never touches the rows. Returns (L, D, K), one
    solution per λ in ``lams``; a one-λ list is the single fit. ``init_x``
    (D, K) warm-starts every λ's passes."""
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)
    diag = [ata[offs[i] : offs[i + 1], offs[i] : offs[i + 1]] for i in range(len(widths))]

    def solve_one(lam: float):
        factors = [ridge_factor(g, lam) for g in diag]
        if init_x is None:
            x = torch.zeros((ata.shape[0], atb.shape[-1]), dtype=ata.dtype, device=ata.device)
        else:
            x = init_x.to(dtype=ata.dtype, device=ata.device).clone()
        for _ in range(num_iter):
            for i in range(len(widths)):
                o, o2 = offs[i], offs[i + 1]
                rhs = atb[o:o2] - ata[o:o2] @ x + diag[i] @ x[o:o2]
                x[o:o2] = ridge_solve_prefactored(factors[i], diag[i], rhs, lam)
        return x

    return torch.stack([solve_one(float(lam)) for lam in lams])


@dataclasses.dataclass(eq=False)
class LeastSquaresEstimator(LabelEstimator):
    """Picks the solver by feature count: a block list or more than
    ``block_size`` features take :class:`BlockLeastSquaresEstimator`,
    else the exact :class:`LinearMapEstimator`."""

    fits_global_rows = True

    lam: float = 0.0
    block_size: int = 4096
    num_iter: int = 1

    def fit(self, data, labels, n_valid: int | None = None) -> Transformer:
        rows = data.local if _is_global(data) else data
        blocked = isinstance(rows, (list, tuple))
        if blocked or rows.shape[-1] > self.block_size:
            est = BlockLeastSquaresEstimator(
                block_size=self.block_size, num_iter=self.num_iter, lam=self.lam
            )
            return est.fit(data, labels, n_valid)
        return LinearMapEstimator(lam=self.lam).fit(data, labels, n_valid)
