"""Class-weighted block-coordinate least squares — port of
``keystone_tpu/ops/weighted_linear.py`` (the reference's
``BlockWeightedLeastSquares.scala``).

The model minimizes a per-class-weighted square loss: an example of class
c gets weight ``(1−w)/n`` on every output column plus ``w/n_c`` extra on
its own class column (``w`` = ``mixture_weight``).

- :class:`BlockWeightedLeastSquaresEstimator` fits in data form
  (:func:`_weighted_bcd_fit`). Rows are permuted once into a class-sorted
  (C, L) grid (:func:`_class_sorted_perm`), so every per-class statistic
  is a reshape and the per-class Grams are batched products costing N·d²
  in all. When the grid would blow up (heavy class imbalance) a one-hot
  masked reduction over the batch takes its place at C·N·d².
- Per-class solves go through Woodbury where the class correction is low
  rank (grid mode, ``L + 2 ≤ d_block // 2``): one factor of the shared
  base ``(1−w)·pop_cov + λI`` per block, (L+1)² inner systems once per
  fit, and only products in the pass loop. Otherwise they are dense
  batched ridge solves, with the pass-invariant systems and factors
  built once when they fit ``_DENSE_HOIST_BUDGET``.
- The streaming protocol (``fit_stats_*``): :class:`WeightedEqState`
  holds the population and per-class statistics, and
  :func:`_weighted_gram_fit` runs the same passes on them.
- A global batch (:class:`~keystone_tpu_torch.parallel.multihost.GlobalRows`,
  rows spread over processes) takes the masked path on each process's
  rows, as the reference's non-addressable arrays do, with every
  contraction over rows summed over the processes that hold the row
  blocks: the counts, the population mean and covariance, the per-class
  sums and Grams (one class chunk an all-reduce), the residual's cross
  terms and means. The residual itself stays with each process's rows.

Where the reference maps over class chunks with ``lax.map``, the port
loops over class ranges of batched ``torch.linalg`` calls; its
``fori_loop`` over passes is a loop. Everything runs under
:func:`~keystone_tpu_torch.ops.linear._matmul_precision`, where ``None``
means full f32 on the card (and the env knob when set).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from keystone_tpu_torch.core.pipeline import LabelEstimator
from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.ops.linear import (
    BlockLinearMapper,
    _concat_blocks,
    _matmul_precision,
    _row_mask,
    _split_blocks,
    block_widths,
    ridge_factor,
    ridge_solve_prefactored,
    stabilized_cho_solve,
)

# per-block memory budget (bytes) for hoisting the dense path's
# pass-invariant per-class systems and factors out of the pass loop:
# 2 · C · d_block² · 4 B must fit beside the rest of the fit
_DENSE_HOIST_BUDGET = 2 << 30

# transient budget (bytes) for one Woodbury solve group: classes are
# grouped to fill it (v + y + about 4 like-sized transients a class),
# which solves TIMIT's 147 classes in one group and ImageNet's 1,000 in two
_WOODBURY_CHUNK_BUDGET = 4 << 30


@dataclasses.dataclass(eq=False)
class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    """Weighted BCD (the reference's BlockWeightedLeastSquaresEstimator).

    ``labels``: (N, C) ±1 indicators, one positive class a row.
    ``class_chunk``: classes solved a step on the dense path (peak memory
    ``class_chunk · d_block²``). ``precision`` pins the products' float32
    precision; ``None`` is full f32 unless ``KEYSTONE_MATMUL_PRECISION``
    says otherwise."""

    block_size: int = 4096
    num_iter: int = 1
    lam: float = 0.0
    mixture_weight: float = 0.5
    class_chunk: int = 16
    precision: str | None = None

    fits_global_rows = True

    def fit(
        self,
        data,
        labels,
        n_valid: int | None = None,
        init: BlockLinearMapper | None = None,
    ) -> BlockLinearMapper:
        """A ``GlobalRows`` ``data`` (``labels`` a ``GlobalRows`` of the
        same layout or this process's label rows) fits the global batch:
        the masked path on this process's rows, each sum over rows summed
        over ``data.group`` (see the module docstring); ``n_valid`` is then
        the batch's own."""
        from keystone_tpu_torch.parallel.multihost import GlobalRows, all_reduce_

        psum = _local
        if isinstance(data, GlobalRows):
            rows, data = data, _concat_blocks(data.local)
            labels = labels.local if isinstance(labels, GlobalRows) else labels
            labels = labels.to(data.device)
            if labels.shape[0] < data.shape[0]:  # the labels end before the pad rows
                labels = torch.cat([labels, labels.new_zeros(
                    (data.shape[0] - labels.shape[0], labels.shape[-1]))])
            n_valid, perm = rows.n_valid, None

            def psum(t):
                return all_reduce_(t.reshape(-1).clone(), group=rows.group).reshape(t.shape)
        else:
            perm = _grid_of(labels, n_valid)
        c = labels.shape[-1]
        sort_idx, class_l = None, None
        if perm is not None:  # None: too imbalanced, the grid would blow up
            sort_idx, class_l = perm.reshape(-1), perm.shape[1]
        with _matmul_precision(self.precision):
            xs, b = _weighted_bcd_fit(
                data,
                labels,
                sort_idx,
                n_valid,
                class_l,
                self.block_size,
                self.num_iter,
                self.lam,
                self.mixture_weight,
                min(self.class_chunk, c),
                init_xs=None if init is None else tuple(init.xs),
                psum=psum,
            )
        return BlockLinearMapper(xs=xs, b=b, means=None, block_size=self.block_size)

    # -- streaming per-class statistics protocol (fit_stats_*) ----------
    # The weighted objective's sufficient statistics are the population
    # Gram plus per-class Grams and sums, so the fit streams like the
    # plain solvers at (C, D, D) state residency; the planner prices that
    # state against the memory budget and falls back to the materialized
    # fit when it does not fit.

    def fit_stats_init(self, d: int, c: int, device=None) -> "WeightedEqState":
        return weighted_eq_init(d, c, device)

    def fit_stats_update(
        self, state, data, labels, n_valid=None, gram_fn=None
    ) -> "WeightedEqState":
        # gram_fn is accepted for the protocol's sake and not used: the
        # per-class Grams set the solves' conditioning and stay exact
        return weighted_eq_update(state, data, labels, n_valid, precision=self.precision)

    def fit_stats_finalize(self, state, widths=None) -> BlockLinearMapper:
        d = state.ata.shape[0]
        widths = tuple(widths) if widths else block_widths(d, self.block_size)
        with _matmul_precision(self.precision):
            x, b = _weighted_gram_fit(
                state, widths, self.num_iter, self.lam, self.mixture_weight
            )
        offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)
        xs = tuple(x[offs[i] : offs[i + 1]] for i in range(len(widths)))
        return BlockLinearMapper(xs=xs, b=b, means=None, block_size=self.block_size)

    @staticmethod
    def fit_stats_flops_per_row(d: int, c: int) -> float:
        # population Gram + AᵀY + the masked per-class Gram contraction
        return 2.0 * d * (d + c) + 2.0 * c * d * d

    @staticmethod
    def fit_stats_state_bytes(d: int, c: int) -> int:
        return 4 * (c * d * d + d * d + 2 * d * c + d + 2 * c)

    def fit_stats_peak_bytes(self, d: int, c: int) -> int:
        """What the streamed fit holds at its peak: the state plus the
        finalize's per-class covariances, systems and factors of the
        widest block (three (C, d_block, d_block) f32 arrays)."""
        b = min(self.block_size, d)
        return self.fit_stats_state_bytes(d, c) + 3 * 4 * c * b * b


def _class_sorted_perm(class_idx: np.ndarray, c: int, n_rows: int) -> np.ndarray | None:
    """(C, L) row-index grid: row c lists the batch rows of class c, padded
    with the sentinel ``n_rows`` (gathers hit an appended zero row).

    L is the largest class count rounded up to 64 rows. Returns None when
    the padded grid would exceed about twice the batch (heavy class
    imbalance: L is sized to the LARGEST class) — the caller then takes
    the masked path."""
    counts = np.bincount(class_idx, minlength=c)
    l_pad = max(-(-int(counts.max()) // 64) * 64, 64) if len(class_idx) else 64
    if c * l_pad > 2 * n_rows + 64 * c:
        return None
    perm = np.full((c, l_pad), n_rows, np.int64)
    order = np.argsort(class_idx, kind="stable")
    offsets = np.zeros(c + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    for ci in range(c):
        seg = order[offsets[ci] : offsets[ci + 1]]
        perm[ci, : len(seg)] = seg
    return perm


def _grid_of(labels, n_valid=None) -> np.ndarray | None:
    """:func:`_class_sorted_perm` of (N, C) ±1 indicators, built on the
    host from the valid rows' argmax (one (N,) copy)."""
    n_val = labels.shape[0] if n_valid is None else int(n_valid)
    class_idx = torch.argmax(labels[:n_val], dim=-1).cpu().numpy()
    return _class_sorted_perm(class_idx, labels.shape[-1], labels.shape[0])


def _solve_plan(class_l, widths, c: int, class_chunk: int, num_iter: int,
                itemsize: int) -> list[tuple[str, int]]:
    """Per feature block of width ``widths[i]``: its solve path and the
    classes solved a step. ``woodbury`` where the grid layout makes the
    class correction low rank (``L + 2 ≤ d_block // 2``), with classes
    grouped to fill ``_WOODBURY_CHUNK_BUDGET`` (v, y and about 4
    like-sized transients a class); else ``dense_hoisted`` for a
    multi-pass fit whose 2·C·d² pass-invariant systems and factors fit
    the blocks' share of ``_DENSE_HOIST_BUDGET``; else ``dense``, both
    ``class_chunk`` classes a step."""
    woodbury = [class_l is not None and class_l + 2 <= d // 2 for d in widths]
    n_dense = sum(not u for u in woodbury) if num_iter > 1 else 0
    per_block_budget = _DENSE_HOIST_BUDGET // max(n_dense, 1)
    c_pad = -(-c // class_chunk) * class_chunk
    plan = []
    for d, wood in zip(widths, woodbury):
        if wood:
            per_class = 6 * d * (class_l + 1) * itemsize
            group = max(int(_WOODBURY_CHUNK_BUDGET // per_class), class_chunk)
            plan.append(("woodbury", max(1, min(group, c))))
        elif num_iter > 1 and 2 * c_pad * d * d * itemsize <= per_block_budget:
            plan.append(("dense_hoisted", class_chunk))
        else:
            plan.append(("dense", class_chunk))
    return plan


def _one_hot(class_idx: torch.Tensor, c: int, dtype) -> torch.Tensor:
    """(N, C) one-hot rows as an ``arange`` comparison (``F.one_hot``
    asserts on out-of-range indices where ``jax.nn.one_hot`` gives zeros)."""
    return (class_idx[:, None] == torch.arange(c, device=class_idx.device)).to(dtype)


def _class_ranges(c: int, s_chunk: int) -> list[tuple[int, int]]:
    """The reference's class chunks as ``[lo, hi)`` ranges; its padded
    classes of the last chunk are dropped, not solved."""
    return [(lo, min(lo + s_chunk, c)) for lo in range(0, c, s_chunk)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A sum over this process's rows as it is: the batch is all here."""
    return t


def _chunk_joint_xtx(stat, pop_cov, pop_mean, class_l, w, psum=_local):
    """One chunk's per-class systems (S, d, d):
    (1−w)·pop_cov + w·class_cov + w(1−w)·md mdᵀ, with class_cov from
    CENTERED rows: the class rows in grid mode (sentinel slots masked back
    to zero), and in the fallback the one-hot masked reduction of the
    rows centered on their own class's mean (``stat["centered"]``), whose
    per-class Grams ``psum`` sums over the processes of a global batch."""
    mu = stat["class_mean"]  # (S, d)
    if class_l is not None:
        valid = (
            torch.arange(class_l, device=mu.device)[None, :] < stat["n_c"][:, None]
        ).to(mu.dtype)  # (S, L)
        rows_c = (stat["a_rows"] - mu[:, None, :]) * valid[:, :, None]
        g = torch.einsum("sld,sle->sde", rows_c, rows_c)
    else:
        rows_c = stat["centered"]
        g = psum(torch.einsum("nd,ns,ne->sde", rows_c, stat["onehot"], rows_c))
    class_cov = g / stat["n_c"][:, None, None]
    md = mu - pop_mean  # (S, d)
    return (
        (1 - w) * pop_cov[None]
        + w * class_cov
        + w * (1 - w) * torch.einsum("sd,se->sde", md, md)
    )


def _inv_spd(g: torch.Tensor) -> torch.Tensor:
    """Exact equilibrated-Cholesky inverse of each SPD (L+1)² Woodbury
    inner matrix of a (S, L+1, L+1) batch (eigenvalues ≥ 1, but their
    spread tracks ‖B⁻¹‖)."""
    lp1 = g.shape[-1]
    eye = torch.eye(lp1, dtype=g.dtype, device=g.device)
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(g, dim1=-2, dim2=-1), 1e-30))
    scale = s[:, :, None] * s[:, None, :]
    cf = torch.linalg.cholesky(g * scale + 1e-6 * eye)
    return torch.cholesky_solve(eye.expand_as(g), cf) * scale


def _weighted_bcd_fit(
    data,
    labels,
    sort_idx,
    n_valid,
    class_l: int | None,
    block_size: int,
    num_iter: int,
    lam: float,
    mixture_weight: float,
    class_chunk: int,
    init_xs=None,
    psum=_local,
):
    """Weighted BCD body. ``class_l`` non-None means ``sort_idx`` lays the
    rows out as a class-sorted (C, class_l) grid (grid row r belongs to
    class r // class_l; sentinel indices point at an appended zero row);
    None falls back to one-hot masked reductions over the batch. ``psum``
    (masked layout only) sums a contraction over rows across the
    processes of a global batch (the identity in one process): every
    count, mean and Gram is global before a centered sum or a solve uses
    it. Returns the per-block weights and the (C,) intercept."""
    w = mixture_weight
    dtype, dev = data.dtype, data.device
    c = labels.shape[-1]
    if class_l is not None:
        n_orig = data.shape[0]
        sort_idx = torch.as_tensor(sort_idx, device=dev)
        data = torch.cat([data, data.new_zeros((1, data.shape[-1]))])[sort_idx]
        labels = torch.cat([labels.to(dtype), labels.new_zeros((1, c), dtype=dtype)])[sort_idx]
        mask = (sort_idx < n_orig)[:, None].to(dtype)
    else:
        labels = labels.to(dtype)
        mask = _row_mask(data.shape[0], n_valid, dtype, dev)
    blocks = _split_blocks(data, block_size)
    n_rows = blocks[0].shape[0]
    n = psum(mask.sum())

    def masked_rows(a):
        # grid mode: every gathered row is a real row or the all-zero
        # sentinel, so ``a * mask`` would be an identity
        return a if class_l is not None else a * mask

    if class_l is not None:
        class_idx = torch.arange(n_rows, device=dev) // class_l  # layout-defined
    else:
        class_idx = torch.argmax(labels, dim=-1)
    onehot = _one_hot(class_idx, c, dtype) * mask  # (N, C), pad rows zeroed
    n_c = psum(onehot.sum(0))  # (C,)
    n_c_safe = torch.clamp_min(n_c, 1.0)

    # jointLabelMean[c] = 2w + 2(1−w)·n_c/n − 1
    joint_label_mean = 2 * w + 2 * (1 - w) * n_c / n - 1
    resid = (labels - joint_label_mean) * mask  # (N, C)

    def residual_mean(r):
        # the population column mean of the residual (the JAX package's
        # deliberate fix of the reference's uniform per-class average)
        r_m = r if class_l is not None else r * mask
        return psum(r_m.sum(0)) / n  # (C,)

    res_mean = residual_mean(resid)

    def class_sum(x):
        """Per-class column sums of a row-major (N, ...) array → (C, ...)."""
        if class_l is not None:
            return x.reshape(c, class_l, *x.shape[1:]).sum(1)
        return psum((onehot.T @ x.reshape(n_rows, -1)).reshape(c, *x.shape[1:]))

    # pass-invariant per-block statistics, plus — where the Woodbury path
    # applies — the stabilized inverse of its base B = (1−w)·pop_cov + λI
    paths = _solve_plan(class_l, [a.shape[-1] for a in blocks], c, class_chunk, num_iter,
                        data.element_size())
    use_woodbury = [path == "woodbury" for path, _ in paths]
    pop_means, pop_covs, class_means, joint_means, b_invs = [], [], [], [], []
    for i, a in enumerate(blocks):
        a_m = masked_rows(a)
        pop_mean = psum(a_m.sum(0)) / n
        # covariance from CENTERED rows, not gram/n − μμᵀ (cancellation),
        # centered on the global mean before the sum over processes
        a_cm = (a - pop_mean) * mask
        pop_cov = psum(a_cm.T @ a_cm) / n
        del a_cm
        class_mean = class_sum(a_m) / n_c_safe[:, None]  # (C, d)
        pop_means.append(pop_mean)
        pop_covs.append(pop_cov)
        class_means.append(class_mean)
        joint_means.append(w * class_mean + (1 - w) * pop_mean)  # (C, d)
        if use_woodbury[i]:
            eye = torch.eye(a.shape[-1], dtype=dtype, device=dev)
            b_invs.append(stabilized_cho_solve((1 - w) * pop_cov + lam * eye)(eye))
        else:
            b_invs.append(None)

    def class_centered(i, a_m):
        """Masked layout: block i's rows centered on their own class's
        (global) mean, pad rows zero, built once a block for every class
        chunk; None in grid mode, which centers the class rows a chunk
        at a time."""
        if class_l is not None:
            return None
        return (a_m - class_means[i][class_idx]) * mask

    def class_static_stats(i, a_m, lo, hi, centered=None):
        """Pass-invariant per-class stats of block i's classes [lo, hi):
        means, counts, and the class rows (grid, a view) or the one-hot
        columns and ``class_centered``'s rows (masked)."""
        stat = {"class_mean": class_means[i][lo:hi], "n_c": n_c_safe[lo:hi]}
        if class_l is not None:
            stat["a_rows"] = a_m.reshape(c, class_l, -1)[lo:hi]
        else:
            stat["onehot"], stat["centered"] = onehot[:, lo:hi], centered
        return stat

    # Woodbury prep, once a fit: M_c = B + V Vᵀ with
    #   V = [√(w/n_c)·(A_c − μ_c)ᵀ, √(w(1−w))·md_c]   (L+1 columns),
    # Y = B⁻¹V and G⁻¹ = (I + VᵀB⁻¹V)⁻¹, so a pass's solves are products
    wood_pre = []
    for i, a in enumerate(blocks):
        if not use_woodbury[i]:
            wood_pre.append(None)
            continue
        a_m = masked_rows(a)
        lp1 = class_l + 1
        eye_l = torch.eye(lp1, dtype=dtype, device=dev)
        chunks = []
        for lo, hi in _class_ranges(c, paths[i][1]):
            stat = class_static_stats(i, a_m, lo, hi)
            mu = stat["class_mean"]  # (S, d)
            md = mu - pop_means[i]
            scale = torch.sqrt(w / torch.clamp_min(stat["n_c"], 1.0))
            # center the class rows about μ_c; sentinel slots hold zero
            # rows, which centering would turn into −μ_c: mask them back
            valid = (
                torch.arange(class_l, device=dev)[None, :] < stat["n_c"][:, None]
            ).to(dtype)  # (S, L)
            centered = (stat["a_rows"] - mu[:, None, :]) * valid[:, :, None]  # (S, L, d)
            v = torch.cat(
                [
                    centered.transpose(1, 2) * scale[:, None, None],
                    (float(np.sqrt(w * (1 - w))) * md)[:, :, None],
                ],
                dim=2,
            )  # (S, d, L+1)
            del centered
            y = torch.einsum("de,sek->sdk", b_invs[i], v)  # B⁻¹V
            g = torch.einsum("sdi,sdj->sij", v, y) + eye_l
            chunks.append({"lo": lo, "hi": hi, "v": v, "y": y, "ginv": _inv_spd(g)})
        wood_pre.append(chunks)

    # dense-path hoist: the per-class systems and their factors are
    # pass-invariant too, built once where the plan says they fit
    dense_pre = []
    for i, a in enumerate(blocks):
        if paths[i][0] != "dense_hoisted":
            dense_pre.append(None)
            continue
        a_m = masked_rows(a)
        centered = class_centered(i, a_m)
        chunks = []
        for lo, hi in _class_ranges(c, class_chunk):
            jxtx = _chunk_joint_xtx(
                class_static_stats(i, a_m, lo, hi, centered), pop_covs[i], pop_means[i],
                class_l, w, psum,
            )
            chunks.append({"lo": lo, "hi": hi, "jxtx": jxtx, "factor": ridge_factor(jxtx, lam)})
        del centered
        dense_pre.append(chunks)

    xs = [torch.zeros((a.shape[-1], c), dtype=dtype, device=dev) for a in blocks]
    if init_xs is not None:
        # warm start: adopt the model and put the residual in the
        # consistent state R = (labels − mean) − Σ A_i x_i
        xs = [x.to(dtype=dtype, device=dev) for x in init_xs]
        for blk_a, x in zip(blocks, xs):
            resid = resid - masked_rows(blk_a) @ x
        res_mean = residual_mean(resid)

    def chunk_rhs(stat):
        joint_xtr = (
            (1 - w) * stat["pop_xtr"]
            + w * stat["class_xtr"]
            - stat["joint_mean"] * stat["mean_mix"][:, None]
        )
        return joint_xtr - lam * stat["model_col"]  # (S, d)

    def woodbury_solve(pre, rhs, b_inv, pop_cov):
        v, y, ginv = pre["v"], pre["y"], pre["ginv"]

        def wsolve(r):  # M⁻¹r = (B + VVᵀ)⁻¹r, all products
            z = r @ b_inv.T
            t = torch.einsum("sij,sj->si", ginv, torch.einsum("sdi,sd->si", v, z))
            return z - torch.einsum("sdi,si->sd", y, t)

        def matvec(x):  # (joint_xtx + λI) x, never formed
            bx = (1 - w) * (x @ pop_cov.T) + lam * x
            return bx + torch.einsum("sdi,si->sd", v, torch.einsum("sdi,sd->si", v, x))

        x = wsolve(rhs)
        # three refinement steps against the true operator recover the
        # digits the Woodbury apply cancels when B is ill-conditioned
        for _ in range(3):
            x = x + wsolve(rhs - matvec(x))
        return x  # (S, d)

    for _ in range(num_iter):
        for i, a in enumerate(blocks):
            a_m = masked_rows(a)
            pop_xtr = psum(a_m.T @ resid) / n  # (d, C)
            # per-class residual stats restricted to own-class rows/column
            if class_l is not None:
                # grid mode: row (c, l)'s own-class column IS column c
                r_own = torch.diagonal(resid.reshape(c, class_l, c), dim1=0, dim2=2)
                r_own = r_own.T.reshape(-1, 1)  # (N, 1)
            else:
                r_own = (resid * onehot).sum(-1, keepdim=True)  # (N, 1)
            class_xtr = class_sum(a_m * r_own) / n_c_safe[:, None]  # (C, d)
            r_own_mean = class_sum(r_own)[:, 0] / n_c_safe  # (C,)
            mean_mix = (1 - w) * res_mean + w * r_own_mean  # (C,)

            def stats_of(lo, hi):
                return {
                    "class_xtr": class_xtr[lo:hi],
                    "joint_mean": joint_means[i][lo:hi],
                    "mean_mix": mean_mix[lo:hi],
                    "pop_xtr": pop_xtr.T[lo:hi],
                    "model_col": xs[i].T[lo:hi],
                }

            deltas = []
            if use_woodbury[i]:
                for pre in wood_pre[i]:
                    rhs = chunk_rhs(stats_of(pre["lo"], pre["hi"]))
                    deltas.append(woodbury_solve(pre, rhs, b_invs[i], pop_covs[i]))
            elif dense_pre[i] is not None:
                # hoisted systems: rhs assembly + prefactored solves
                for pre in dense_pre[i]:
                    rhs = chunk_rhs(stats_of(pre["lo"], pre["hi"]))
                    deltas.append(
                        ridge_solve_prefactored(pre["factor"], pre["jxtx"], rhs[:, :, None], lam)[:, :, 0]
                    )
            else:
                # dense per-class normal equations (big classes or the
                # masked fallback), built and solved a chunk at a time
                centered = class_centered(i, a_m)
                for lo, hi in _class_ranges(c, class_chunk):
                    stat = stats_of(lo, hi)
                    stat.update(class_static_stats(i, a_m, lo, hi, centered))
                    jxtx = _chunk_joint_xtx(stat, pop_covs[i], pop_means[i], class_l, w, psum)
                    rhs = chunk_rhs(stat)[:, :, None]
                    deltas.append(
                        ridge_solve_prefactored(ridge_factor(jxtx, lam), jxtx, rhs, lam)[:, :, 0]
                    )
                    del jxtx
                del centered
            delta = torch.cat(deltas).T  # (d, C)
            xs[i] = xs[i] + delta
            resid = resid - a_m @ delta
            res_mean = residual_mean(resid)

    # final intercept: b[c] = jointLabelMean[c] − Σ_blocks jointMean_c·x[:, c]
    b = joint_label_mean
    for jm, x in zip(joint_means, xs):
        b = b - torch.einsum("cd,dc->c", jm, x)
    return tuple(xs), b


def fit_path(est: BlockWeightedLeastSquaresEstimator, labels, d: int, n_valid=None) -> dict:
    """What :meth:`BlockWeightedLeastSquaresEstimator.fit` takes for these
    labels and ``d`` float32 features: the ``layout`` (``grid`` or
    ``masked``), the grid's ``class_l``, and per feature block its
    ``width``, ``solve`` path (``woodbury``, ``dense_hoisted`` or
    ``dense``) and count of ``class_chunks``. ``GlobalRows`` labels (a
    global batch) take the masked layout."""
    from keystone_tpu_torch.parallel.multihost import GlobalRows

    if isinstance(labels, GlobalRows):
        labels, perm = labels.local, None
    else:
        perm = _grid_of(labels, n_valid)
    c = labels.shape[-1]
    class_l = None if perm is None else perm.shape[1]
    widths = block_widths(d, est.block_size)
    plan = _solve_plan(class_l, widths, c, min(est.class_chunk, c), est.num_iter, 4)
    return {
        "layout": "masked" if class_l is None else "grid",
        "class_l": class_l,
        "blocks": [{"width": wd, "solve": solve, "class_chunks": -(-c // chunk)}
                   for wd, (solve, chunk) in zip(widths, plan)],
    }


# ---------------------------------------------------------------------------
# Streaming per-class statistics: the weighted fit's fit_stats protocol.
#
# Every quantity _weighted_bcd_fit derives from the rows is a function of
# the accumulated (AᵀA, AᵀY, per-class AᵀA, per-class Σa, Σa, n_c, n):
#
#   pop_cov   = AᵀA/n − μμᵀ
#   class_cov = AᵀA|_c /n_c − μ_c μ_cᵀ
#   pop_xtr   = (AᵀY − Σa·jlmᵀ)/n
#   class_xtr = (1 − jlm_c)·μ_c at x = 0
#
# and a block-i delta updates them in Gram form, so the pass loop runs on
# statistics alone. Centered quantities use the subtraction form.


@dataclasses.dataclass(eq=False)
class WeightedEqState:
    """Running f32 per-class normal-equation statistics."""

    ata: torch.Tensor  # (D, D) Σ a aᵀ over valid rows
    at_labels: torch.Tensor  # (D, C) Σ a yᵀ (±1 indicator labels)
    class_ata: torch.Tensor  # (C, D, D) per-class Σ a aᵀ
    class_sum: torch.Tensor  # (C, D) per-class Σ a
    sum_a: torch.Tensor  # (D,)
    n_c: torch.Tensor  # (C,)
    n: torch.Tensor  # ()


def weighted_eq_init(d: int, c: int, device=None) -> WeightedEqState:
    """Zero state on ``device``: the card unless the caller asks for the
    CPU."""
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return WeightedEqState(
        ata=z(d, d),
        at_labels=z(d, c),
        class_ata=z(c, d, d),
        class_sum=z(c, d),
        sum_a=z(d),
        n_c=z(c),
        n=z(),
    )


def _weighted_eq_update(state, data, labels, n_valid):
    data = _concat_blocks(data)
    f32 = torch.float32
    mask = _row_mask(data.shape[0], n_valid, f32, data.device)
    a = data.to(f32) * mask
    y = labels.to(f32) * mask
    c = labels.shape[-1]
    onehot = _one_hot(torch.argmax(labels, dim=-1), c, f32) * mask
    return WeightedEqState(
        ata=state.ata + a.T @ a,
        at_labels=state.at_labels + a.T @ y,
        class_ata=state.class_ata + torch.einsum("nc,nd,ne->cde", onehot, a, a),
        class_sum=state.class_sum + onehot.T @ a,
        sum_a=state.sum_a + a.sum(0),
        n_c=state.n_c + onehot.sum(0),
        n=state.n + mask.sum(),
    )


def weighted_eq_update(
    state: WeightedEqState, data, labels, n_valid=None, precision: str | None = None
) -> WeightedEqState:
    """Fold one (rows, D) chunk of ±1 indicator-labeled data into the
    per-class statistics; pad rows are masked out of every accumulator.
    ``precision`` pins the products' precision as the materialized fit
    does."""
    with _matmul_precision(precision):
        return _weighted_eq_update(state, data, labels, n_valid)


def _weighted_gram_fit(state: WeightedEqState, widths: tuple, num_iter: int, lam: float,
                       mixture_weight: float):
    """Gram-form weighted BCD — the fixed point of :func:`_weighted_bcd_fit`
    from streamed statistics: per-class solves are dense batched ridge
    solves; a pass costs C·d_block² products and C solves, independent
    of N. Returns the (D, C) weights and the (C,) intercept."""
    w = mixture_weight
    d, c = state.ata.shape[0], state.n_c.shape[0]
    n = torch.clamp_min(state.n, 1.0)
    n_c_safe = torch.clamp_min(state.n_c, 1.0)
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)

    pop_mean = state.sum_a / n  # (D,)
    class_mean = state.class_sum / n_c_safe[:, None]  # (C, D)
    pop_cov = state.ata / n - torch.outer(pop_mean, pop_mean)
    joint_mean = w * class_mean + (1 - w) * pop_mean  # (C, D)
    md = class_mean - pop_mean  # (C, D)

    # jointLabelMean and the x = 0 residual statistics (±1 indicators:
    # Σ_j y_jc = 2n_c − n over valid rows; r_own = 1 − jlm)
    jlm = 2 * w + 2 * (1 - w) * state.n_c / n - 1  # (C,)
    pop_xtr = (state.at_labels - torch.outer(state.sum_a, jlm)) / n  # (D, C)
    class_xtr = (1.0 - jlm)[:, None] * class_mean  # (C, D)
    r_own_mean = 1.0 - jlm  # (C,)
    res_mean = (2 * state.n_c / n - 1.0) - jlm  # (C,)

    # pass-invariant per-(block, class) systems and factors, built once
    systems = []
    for i in range(len(widths)):
        o, o2 = offs[i], offs[i + 1]
        mc = class_mean[:, o:o2]
        class_cov = state.class_ata[:, o:o2, o:o2] / n_c_safe[:, None, None] - torch.einsum(
            "cd,ce->cde", mc, mc
        )
        jxtx = (
            (1 - w) * pop_cov[o:o2, o:o2][None]
            + w * class_cov
            + w * (1 - w) * torch.einsum("cd,ce->cde", md[:, o:o2], md[:, o:o2])
        )  # (C, d_i, d_i)
        systems.append((jxtx, ridge_factor(jxtx, lam)))

    x = torch.zeros((d, c), dtype=torch.float32, device=state.ata.device)
    for _ in range(num_iter):
        for i in range(len(widths)):
            o, o2 = offs[i], offs[i + 1]
            jxtx, factor = systems[i]
            mean_mix = (1 - w) * res_mean + w * r_own_mean  # (C,)
            joint_xtr = (
                (1 - w) * pop_xtr[o:o2].T
                + w * class_xtr[:, o:o2]
                - joint_mean[:, o:o2] * mean_mix[:, None]
            )  # (C, d_i)
            rhs = joint_xtr - lam * x[o:o2].T
            delta = ridge_solve_prefactored(factor, jxtx, rhs[:, :, None], lam)[:, :, 0]
            delta_dc = delta.T  # (d_i, C)
            x[o:o2] += delta_dc
            # Gram-form residual-statistic updates
            pop_xtr = pop_xtr - (state.ata[:, o:o2] @ delta_dc) / n
            class_xtr = class_xtr - torch.einsum(
                "cDe,ec->cD", state.class_ata[:, :, o:o2], delta_dc
            ) / n_c_safe[:, None]
            r_own_mean = r_own_mean - torch.einsum(
                "cd,dc->c", state.class_sum[:, o:o2], delta_dc
            ) / n_c_safe
            res_mean = res_mean - (state.sum_a[o:o2] @ delta_dc) / n
    b = jlm - torch.einsum("cd,dc->c", joint_mean, x)
    return x, b
