"""LM training — port of ``keystone_tpu/models/lm/train.py``: the
optimizer, the train step, the pipeline-parallel step, the loop and the
synthetic corpus.

- :func:`make_optimizer` is optax's ``adamw`` (optionally behind
  ``clip_by_global_norm``, with a constant or warmup-cosine rate) written
  on torch tensors, step for step: every leaf is decayed (no mask), the
  decay is scaled by the scheduled rate, the schedule is read at the
  count before the increment and the bias correction at count + 1, and
  the clip scales by ``max_norm / g_norm`` only when ``g_norm ≥ max_norm``.
- :func:`make_train_step` is one call of loss, gradients and update; the
  loss stays a device scalar.
- :func:`train` draws each step's windows from ``(seed, step)`` alone.

- with a ``checkpoint_dir``, :func:`train` checkpoints the parameters and
  the optimizer state every ``checkpoint_every`` steps (and on the way out
  of a preemption, a signal or a crash) through
  :class:`keystone_tpu_torch.core.checkpoint.TrainCheckpointer`, and a
  rerun resumes from the newest intact step on the same trajectory.
- ``guard`` (or ``KEYSTONE_GUARD``) runs the guarded step: a non-finite
  loss leaves the parameters, both moments and the update count as they
  were, decided on the device (:meth:`AdamW.update_guarded`) with no host
  read per step; :class:`~keystone_tpu_torch.resilience.guards.LossGuard`
  reads the losses once per interval. ``step_timeout_s`` (or
  ``KEYSTONE_STEP_TIMEOUT_S``) arms the step watchdog, and a cluster
  monitor (:mod:`keystone_tpu_torch.resilience.cluster`) hears of every
  completed step.

Across processes (a process group from
:func:`keystone_tpu_torch.parallel.multihost.initialize`, one card per
process), training is data-parallel: every process derives the same global
batch from ``(seed, step)`` and takes its row block, the step all-reduces
the gradients (in buckets) and the loss to their global means before the
clip and AdamW, and the parameters stay the same on every process. In one
process, a mesh whose data axis names several cards trains the batch on
the axis's first card: data parallelism across cards is a process per
card.

A tensor-parallel model (``shard_params`` over a mesh whose model axis
spans processes) trains dp × tp: the ranks of one data row take the same
row block, and the gradients are all-reduced over the data axis only. A
ring or Ulysses model in a group takes the whole batch on every rank, as
the reference does for a non-local ``seq_mode``, with no gradient
all-reduce. :func:`pp_forward`, :func:`next_token_loss_pp` and
:func:`make_pp_train_step` run the block chain as GPipe stages
(:func:`keystone_tpu_torch.parallel.pipeline_parallel.gpipe`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import signal
import threading
import time
from typing import Callable

import numpy as np
import torch

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.models.lm.losses import next_token_loss, token_cross_entropy
from keystone_tpu_torch.models.lm.model import (
    TransformerLM,
    _block_apply,
    _embed,
    has_quantized_leaves,
    remat_wrap,
)
from keystone_tpu_torch.models.lm.sharding import (
    gather_leaf,
    leaf_dims,
    local_leaf,
    whole_shapes,
)

logger = get_logger("keystone_tpu_torch.models.lm_transformer")

_F32 = np.float32
# optax.adamw's defaults, which the JAX package keeps
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax's ``linear_schedule`` (``polynomial_schedule`` at power 1), in
    float32, for ``transition_steps`` ≥ 1."""

    def schedule(count: int):
        c = _F32(min(max(count, 0), transition_steps))
        frac = _F32(1) - c / _F32(transition_steps)
        return _F32(_F32(init_value) - _F32(end_value)) * frac + _F32(end_value)

    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float):
    """optax's ``cosine_decay_schedule`` at exponent 1, in float32."""
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}."
        )

    def schedule(count: int):
        c = _F32(min(float(count), float(decay_steps)))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        decayed = _F32(1 - alpha) * cosine + _F32(alpha)
        return _F32(init_value) * decayed

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], np.float32]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine down to
    ``end_value`` at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = _cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


def pp_forward(model: TransformerLM, tokens, mesh, *, n_micro: int,
               axis: str = "model", data_axis: str | None = None):
    """Pipeline-parallel forward: the block chain runs as GPipe stages
    over the mesh ``axis`` (one group of ``depth/n_stages`` blocks per
    position, microbatches streamed —
    :func:`keystone_tpu_torch.parallel.pipeline_parallel.gpipe`), the
    embedding and the tied logits outside the pipe on every position.
    Dense blocks only (MoE routing wants the expert axis, not the stage
    axis); the parameters stay whole on every position — pp here
    parallelizes compute. A tensor-parallel layout over the mesh's
    ``model`` axis runs inside the stages (pp × dp × tp on a 3-axis
    mesh)."""
    if any(m is not None for m in model.moe_layers):
        raise ValueError(
            "pipeline-parallel path supports dense blocks only (route "
            "experts over the model axis with moe_every instead)"
        )
    if model.seq_mode != "local":
        raise ValueError(
            "pipeline-parallel path requires seq_mode='local': the "
            f"{model.seq_mode!r} attention opens its own shard_map, which "
            "cannot nest inside the pipeline's"
        )
    n_stages = mesh.shape[axis]
    depth = len(model.blocks)
    if depth % n_stages:
        raise ValueError(
            f"depth {depth} not divisible by {n_stages} pipeline stages"
        )
    tokens = torch.as_tensor(tokens, device=model.device).long()
    b = tokens.shape[0]
    if b % n_micro:
        raise ValueError(
            f"batch {b} not divisible by n_micro={n_micro}"
        )
    per = depth // n_stages
    cdt = model.cdt
    x = _embed(model, tokens, cdt)
    # pre-split microbatches here: gpipe's n_micro reshape heuristic is
    # ambiguous when B == n_micro
    x = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    # the per-block leaves stacked: leading axis depth → (stages, per)
    stacked = {
        name: torch.stack([getattr(blk, name) for blk in model.blocks]).reshape(
            n_stages, per, *getattr(model.blocks[0], name).shape)
        for name in ("wq", "wk", "wv", "wo", "w1", "w2")
    }
    ffn = model._ffn()

    def stage_fn(stage_params, act):
        for j in range(per):
            blk = _StageBlock(**{k: v[j] for k, v in stage_params.items()})
            act = _block_apply(
                act, blk, cdt, lambda y, bb: (model._attention(y, bb), None), ffn=ffn,
            )[0]
        return act

    if model.remat:
        stage_fn = remat_wrap(stage_fn, model.remat_policy)
    from keystone_tpu_torch.parallel.pipeline_parallel import gpipe

    out = gpipe(stage_fn, stacked, x, mesh, axis=axis, data_axis=data_axis)
    return model.logits(out.reshape(b, *out.shape[2:]))


@dataclasses.dataclass
class _StageBlock:
    """One block's matrices inside a pipeline stage."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor


def next_token_loss_pp(model: TransformerLM, tokens, mesh, *,
                       n_micro: int, axis: str = "model",
                       data_axis: str | None = None):
    """Next-token CE through the GPipe forward; its backward is the
    reverse pipeline schedule."""
    tokens = torch.as_tensor(tokens, device=model.device)
    logits = pp_forward(
        model, tokens[:, :-1], mesh, n_micro=n_micro, axis=axis,
        data_axis=data_axis,
    )
    return token_cross_entropy(logits, tokens[:, 1:])


def make_pp_train_step(optimizer, mesh, *, n_micro: int,
                       axis: str = "model",
                       data_axis: str | None = None):
    """``step(model, opt_state, tokens) -> (model, opt_state, loss)``: the
    pipeline-parallel loss, the gradient of every float leaf and the
    optimizer's update, the model updated in place. ``data_axis`` composes
    dp × pp: each data row of positions pipelines its own batch slice, and
    every parameter's gradient comes out whole on every position."""

    def step(model: TransformerLM, opt_state, tokens):
        params = model.leaves()
        for p in params:
            p.requires_grad_(True)
        loss = next_token_loss_pp(model, tokens, mesh, n_micro=n_micro, axis=axis,
                                  data_axis=data_axis)
        grads = _grads(loss, params)
        optimizer.update(grads, opt_state, params, sq_norm=_sq_norm_fn(model))
        return model, opt_state, loss.detach()

    return step


def _grads(loss, params) -> list:
    """Every leaf's gradient of ``loss``; a leaf the loss never reads
    (rope's empty position table) has a zero gradient."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def _sq_norm_fn(model: TransformerLM):
    """The squared global gradient norm for the clip when the leaves hold
    shards across processes (a split leaf's squares summed over the model
    axis, a whole leaf's counted once), else None (every leaf is whole)."""
    tp = model.tp
    if tp is None or not tp.local:
        return None
    from keystone_tpu_torch.models.lm.sharding import leaf_dims
    from keystone_tpu_torch.parallel.collectives import all_reduce

    dims = leaf_dims(model)

    def sq_norm(grads):
        split = sum(torch.sum(g * g) for g, d in zip(grads, dims) if d is not None)
        whole = sum(torch.sum(g * g) for g, d in zip(grads, dims) if d is None)
        split = all_reduce(torch.as_tensor(split, device=grads[0].device).reshape(1),
                           tp.comm.group)[0]
        return split + whole

    return sq_norm


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the update count and the two moments
    (f32, one per leaf). The count lives on the host."""

    count: int
    mu: list
    nu: list


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw`` — ``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate`` — behind an optional
    ``clip_by_global_norm``. ``lr`` is a float or a schedule of the
    count. :meth:`update` changes the parameters and the state in place,
    with no host synchronisation."""

    lr: float | Callable[[int], np.float32]
    weight_decay: float = 0.01
    grad_clip: float = 0.0

    def init(self, params) -> AdamWState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamWState(count=0, mu=zeros, nu=[torch.zeros_like(z) for z in zeros])

    def _direction(self, grads, mu, nu, params, inv_bc1, inv_bc2, neg_lr, *,
                   in_place: bool, sq_norm=None) -> tuple[list, list, list]:
        """The one AdamW body both updates share: clip, advance the moments
        (``mu`` and ``nu`` themselves with ``in_place``, else new lists),
        and return ``(mu, nu, upd)`` with upd = −lr·(mu_hat / (sqrt(nu_hat)
        + eps) + wd·p). The bias corrections come as their reciprocals and
        the rate negated, host floats or 0-dim device tensors. ``sq_norm``
        gives the clip's squared global norm when the leaves hold shards."""
        grads = list(grads)
        if self.grad_clip > 0.0:
            # optax.global_norm: sqrt of the sum over leaves of Σx²
            if sq_norm is not None:
                g_norm = torch.sqrt(sq_norm(grads))
            else:
                g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.grad_clip
            grads = [torch.where(keep, g, (g / g_norm) * self.grad_clip) for g in grads]
        b1, b2 = _B1, _B2
        # mu = (1 − b1)·g + b1·mu; nu = (1 − b2)·g² + b2·nu
        if in_place:
            torch._foreach_mul_(mu, b1)
            torch._foreach_mul_(nu, b2)
        else:
            mu, nu = torch._foreach_mul(mu, b1), torch._foreach_mul(nu, b2)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        # the bias corrections divide as a multiply by their f32
        # reciprocal: what CUDA's division by a host scalar computes, so
        # the plain and the guarded update agree bit for bit on every device
        upd = torch._foreach_mul(mu, inv_bc1)
        den = torch._foreach_sqrt(torch._foreach_mul(nu, inv_bc2))
        torch._foreach_add_(den, _EPS)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(list(params), self.weight_decay))
        torch._foreach_mul_(upd, neg_lr)
        return mu, nu, upd

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, sq_norm=None) -> AdamWState:
        params = list(params)
        count_inc = state.count + 1
        bc1 = float(_F32(1) - np.power(_F32(_B1), _F32(count_inc), dtype=_F32))
        bc2 = float(_F32(1) - np.power(_F32(_B2), _F32(count_inc), dtype=_F32))
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        _, _, upd = self._direction(grads, state.mu, state.nu, params, 1.0 / bc1, 1.0 / bc2,
                                    -float(_F32(lr)), in_place=True, sq_norm=sq_norm)
        torch._foreach_add_(params, upd)
        state.count = count_inc
        return state

    def count_tables(self, device, n: int) -> tuple[torch.Tensor, ...]:
        """Per-count f32 tables, rows ``0..n-1``, of the two bias
        corrections' reciprocals and the negated rate: exactly the values
        :meth:`update` takes on the host at each count, for
        :meth:`update_guarded` to index with its device count."""
        inc = np.arange(1, n + 1).astype(_F32)
        bc1 = (_F32(1) - np.power(_F32(_B1), inc, dtype=_F32)).astype(np.float64)
        bc2 = (_F32(1) - np.power(_F32(_B2), inc, dtype=_F32)).astype(np.float64)
        lr = np.array([_F32(self.lr(c) if callable(self.lr) else self.lr) for c in range(n)], _F32)
        tables = ((1.0 / bc1).astype(_F32), (1.0 / bc2).astype(_F32), -lr)
        return tuple(torch.from_numpy(t).to(device) for t in tables)

    @torch.no_grad()
    def update_guarded(self, grads, state: AdamWState, params, ok: torch.Tensor,
                       tables: tuple[torch.Tensor, ...], sq_norm=None) -> AdamWState:
        """:meth:`update` where ``ok`` (a 0-dim device bool) holds, and no
        change at all where it does not: the parameters, both moments and
        the count keep their bits, NaN gradients or not. The count is a
        0-dim int64 device tensor that advances by ``ok``; the bias
        corrections and the rate are read at it from
        :meth:`count_tables` (with a row for every count it can hold), so
        nothing is read back to the host. Where ``ok`` holds the result
        equals :meth:`update`'s bit for bit."""
        params = list(params)
        # index_select, not t[count]: a 0-dim index would be read back to
        # the host
        at = state.count.reshape(1)
        inv_bc1, inv_bc2, neg_lr = (t.index_select(0, at).reshape(()) for t in tables)
        mu, nu, upd = self._direction(grads, state.mu, state.nu, params, inv_bc1, inv_bc2,
                                      neg_lr, in_place=False, sq_norm=sq_norm)
        new_params = torch._foreach_add(params, upd)
        del upd
        from keystone_tpu_torch.resilience.guards import guarded_update

        guarded_update(ok, mu, state.mu)
        guarded_update(ok, nu, state.nu)
        guarded_update(ok, new_params, params)
        state.count.add_(ok.to(torch.int64))
        return state


def make_optimizer(
    lr: float,
    *,
    steps: int = 0,
    schedule: str = "constant",
    warmup_frac: float = 0.05,
    grad_clip: float = 0.0,
    weight_decay: float = 0.01,
) -> AdamW:
    """The LM training optimizer: AdamW, optionally behind global-norm
    gradient clipping, with a constant or warmup-cosine learning rate.
    ``schedule="cosine"`` warms up over ``warmup_frac`` of ``steps`` and
    decays to lr/10."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"schedule={schedule!r}; expected constant|cosine")
    rate: float | Callable = lr
    if schedule == "cosine":
        if steps <= 0:
            raise ValueError("schedule='cosine' needs the total steps")
        rate = warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=lr,
            warmup_steps=max(1, int(steps * warmup_frac)),
            decay_steps=steps,
            end_value=lr / 10.0,
        )
    return AdamW(rate, weight_decay=weight_decay, grad_clip=grad_clip)


# gradients are all-reduced in buckets of at most this many bytes: one
# collective per bucket, not one per leaf
_BUCKET_BYTES = 64 << 20


def allreduce_mean_(grads: list, loss: torch.Tensor, group=None) -> torch.Tensor:
    """The data-parallel reduction: every gradient (in place, in flat
    buckets of at most ``_BUCKET_BYTES`` of one dtype) and the loss become
    their means over the process group (``group``, an
    :class:`~keystone_tpu_torch.parallel.collectives.AxisGroup`, when the
    data axis is a part of it). Each process's loss and gradients are means
    over its own equal share of the batch, so these means are the global
    batch's. Returns the reduced loss."""
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.parallel.collectives import all_reduce

    world = multihost.process_count() if group is None else group.size
    if world == 1:
        return loss

    def reduce_(t):
        if group is None:
            return multihost.all_reduce_(t)
        return t.copy_(all_reduce(t, group))

    bucket: list = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        reduce_(flat).div_(world)
        off = 0
        for g in bucket:
            g.copy_(flat[off : off + g.numel()].view_as(g))
            off += g.numel()
        bucket.clear()

    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype or size + g.numel() * g.element_size() > _BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        flush()
    loss = loss.reshape(1).clone()
    return reduce_(loss).div_(world).reshape(())


def make_train_step(optimizer: AdamW, *, logit_chunk: int = 0, guarded: bool = False,
                    skip_nonfinite: bool = True, data_parallel: bool = False):
    """``step(model, opt_state, tokens) -> (model, opt_state, loss)``:
    next-token loss, the gradient of every float leaf, and the optimizer's
    update, in one call. The step turns on ``requires_grad`` of the leaves
    it updates; the model and the state are updated in place and handed
    back, as the JAX package's donated step hands back new ones. ``loss``
    is a device scalar. ``logit_chunk`` chunks the CE.

    ``guarded=True`` returns ``step(model, opt_state, tokens, poison)``:
    ``poison`` (a host bool, the ``train.nan`` fault) multiplies the loss
    by NaN, so the backward pass NaNs too — an injected bad batch corrupts
    exactly what a real one would, and the unpoisoned step is the plain
    one. With ``skip_nonfinite`` (a guard mode is on) the update goes
    through :meth:`AdamW.update_guarded`: applied only where the loss is
    finite, decided on the device; ``opt_state.count`` is then a device
    tensor."""

    def grads_of(model: TransformerLM, tokens, poison: bool = False):
        params = model.leaves()
        for p in params:
            p.requires_grad_(True)
        loss = next_token_loss(model, tokens, logit_chunk=logit_chunk)
        if poison:
            loss = loss * float("nan")
        grads = _grads(loss, params)
        loss = loss.detach()
        if data_parallel:
            loss = allreduce_mean_(grads, loss, _data_group(model))
        return params, grads, loss

    def step(model: TransformerLM, opt_state: AdamWState, tokens):
        params, grads, loss = grads_of(model, tokens)
        optimizer.update(grads, opt_state, params, sq_norm=_sq_norm_fn(model))
        return model, opt_state, loss

    if not guarded:
        return step
    # the host's bound on the device count (the count at the first call,
    # one read, then one more a step) and the count tables covering it
    seen = {"bound": None, "tables": None}

    def guarded_step(model: TransformerLM, opt_state: AdamWState, tokens, poison: bool):
        params, grads, loss = grads_of(model, tokens, poison)
        if not skip_nonfinite:
            optimizer.update(grads, opt_state, params, sq_norm=_sq_norm_fn(model))
            return model, opt_state, loss
        if not isinstance(opt_state.count, torch.Tensor):
            opt_state.count = torch.tensor(opt_state.count, dtype=torch.int64, device=loss.device)
        if seen["bound"] is None:
            seen["bound"] = int(opt_state.count)
        seen["bound"] += 1
        if seen["tables"] is None or len(seen["tables"][0]) < seen["bound"]:
            seen["tables"] = optimizer.count_tables(loss.device, max(64, 2 * seen["bound"]))
        optimizer.update_guarded(grads, opt_state, params, torch.isfinite(loss), seen["tables"],
                                 sq_norm=_sq_norm_fn(model))
        return model, opt_state, loss

    return guarded_step


def _step_batch(corpus, seed: int, i: int, batch: int, seq: int):
    """Step ``i``'s token windows, derived from ``(seed, i)`` alone — no
    sequential RNG state, so a resumed run regenerates the exact batch
    sequence an uninterrupted run would have seen."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, i)))
    starts = rng.integers(0, len(corpus) - seq - 1, size=batch)
    return np.stack([corpus[s : s + seq + 1] for s in starts])


def _data_group(model: TransformerLM):
    """The group a data-parallel step reduces over: the data axis of a
    tensor-parallel model's mesh across processes, else None (every
    process)."""
    tp = model.tp
    if tp is None or not tp.local:
        return None
    return tp.mesh.axis_group("data")


def _data_parallel(*, model, batch, mesh) -> tuple[int, int] | None:
    """This process's rows ``(lo, hi)`` of each global batch when training
    is data-parallel across processes, else None. A ring or Ulysses model
    in a group takes the whole batch on every rank; a tensor-parallel
    model takes its data row's block, the whole batch on a mesh with one
    data row. In one process, a mesh whose data axis would shard a local
    model's batch trains it on the axis's first card, and says so once."""
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.resilience.cluster import process_count

    world = multihost.process_count()
    if world == 1 and process_count() > 1:
        raise RuntimeError(
            f"train() in a job of {process_count()} processes outside a process group: "
            "call keystone_tpu_torch.parallel.multihost.initialize() first (the "
            "launcher's --multihost does), so the processes train data-parallel"
        )
    if world > 1:
        if model.seq_mode != "local":
            # the sequence is the split axis: the batch is replicated
            return None
        tp = model.tp
        if tp is not None and tp.local:
            n_data = tp.mesh.shape.get("data", 1)
            if n_data == 1:
                return None
            if batch % n_data:
                raise ValueError(f"batch {batch} does not split over {n_data} data rows")
            return multihost.row_block(batch, tp.mesh.coords()["data"], n_data)
        if batch % world:
            raise ValueError(f"batch {batch} does not split over {world} processes")
        return multihost.row_block(batch)
    if (
        mesh is not None
        and model.seq_mode == "local"
        and mesh.shape.get("data", 1) > 1
        and batch % mesh.shape["data"] == 0
        and not _warned["one_card"]
    ):
        _warned["one_card"] = True
        logger.warning(
            "train(mesh=%s) in one process: the batch trains on %s; data "
            "parallelism across cards is a process per card (--multihost)",
            dict(mesh.shape), model.device,
        )
    return None


_warned = {"one_card": False}


def _broadcast_replicas(model: TransformerLM) -> None:
    """Every data-parallel replica's parameters made process 0's (the
    first data row's, for each model-axis shard)."""
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.parallel.collectives import broadcast

    group = _data_group(model)
    with torch.no_grad():
        for p in model.leaves():
            if group is None:
                multihost.broadcast_(p)
            else:
                p.copy_(broadcast(p, group, 0))


def _run_identity(model: TransformerLM, corpus, *, batch, seq, lr, seed, schedule,
                  grad_clip, logit_chunk, guarded) -> dict:
    """Everything that shapes a run's trajectory, for the checkpoint's
    identity check; ``steps`` is left out on purpose (resuming with a
    longer schedule is the point; the over-trained guard covers a shorter
    one)."""
    corpus_head = np.asarray(corpus[:64], np.int64)
    return {
        "kind": "lm_transformer",
        "batch": batch,
        "seq": seq,
        "lr": lr,
        "seed": seed,
        "schedule": schedule,
        "grad_clip": grad_clip,
        "logit_chunk": logit_chunk,
        # the guarded step may move low bits, so it IS run identity:
        # False = plain step, "inject" = poison only, "skip" = poison and
        # the on-device skip
        "guarded": guarded,
        "num_heads": model.num_heads,
        "num_kv_heads": model.kv_heads,
        "seq_mode": model.seq_mode,
        "compute_dtype": model.compute_dtype,
        "pos_encoding": model.pos_encoding,
        "remat": model.remat,
        "remat_policy": model.remat_policy,
        "moe_aux_weight": model.moe_aux_weight,
        "moe_experts": [None if m is None else m.num_experts for m in model.moe_layers],
        "moe_capacity": [None if m is None else m.capacity_factor for m in model.moe_layers],
        "corpus_len": int(len(corpus)),
        "corpus_head_sha": hashlib.sha256(corpus_head.tobytes()).hexdigest()[:16],
        "param_shapes": [list(map(int, shape)) for shape in whole_shapes(model)],
    }


def _legacy_defaults(model: TransformerLM) -> dict:
    """Values for identity keys that older checkpoints lack: what the
    code used before the key existed."""
    return {
        "pos_encoding": "learned",
        "schedule": "constant",
        "grad_clip": 0.0,
        "logit_chunk": 0,
        "guarded": False,
        "remat_policy": "full",
        "num_kv_heads": model.num_heads,
    }


def _train_state(model: TransformerLM, opt_state: AdamWState) -> dict:
    """The checkpointed state: every parameter, both moments and the
    update count (a host int, saved as a tensor). A leaf split over
    processes is gathered whole over the model axis, so a sharded run
    writes the format an unsharded one does (:func:`_restore_shards` puts
    a restored whole state back into the shards)."""
    if model.tp is not None and model.tp.local:
        dims = leaf_dims(model)
        whole = lambda ts: [gather_leaf(model, t, d).clone() for t, d in zip(ts, dims)]  # noqa: E731
        return {"params": whole(model.leaves()), "mu": whole(opt_state.mu),
                "nu": whole(opt_state.nu), "count": _count_tensor(opt_state)}
    return {
        "params": model.leaves(),
        "mu": opt_state.mu,
        "nu": opt_state.nu,
        "count": _count_tensor(opt_state),
    }


def _count_tensor(opt_state: AdamWState) -> torch.Tensor:
    # the guarded step's count is a device tensor, restored in place
    if isinstance(opt_state.count, torch.Tensor):
        return opt_state.count
    return torch.tensor(opt_state.count, dtype=torch.int64)


def _restore_shards(model: TransformerLM, opt_state: AdamWState, state: dict) -> None:
    """Copy this rank's shards of a restored whole state (from
    :func:`_train_state` of a model split over processes) into the model
    and the optimizer state."""
    if model.tp is None or not model.tp.local:
        return
    with torch.no_grad():
        for key, dst in (("params", model.leaves()), ("mu", opt_state.mu), ("nu", opt_state.nu)):
            for t, whole, d in zip(dst, state[key], leaf_dims(model)):
                t.copy_(local_leaf(model, whole, d))


def _emit_resilience(action: str, **fields) -> None:
    from keystone_tpu_torch.resilience.emit import decision

    decision(action, **fields)


def train(
    model: TransformerLM,
    corpus: np.ndarray,
    *,
    steps: int,
    batch: int,
    seq: int,
    lr: float = 3e-4,
    mesh=None,
    seed: int = 0,
    log_every: int = 0,
    checkpoint_dir: str = "",
    checkpoint_every: int = 0,
    schedule: str = "constant",
    grad_clip: float = 0.0,
    logit_chunk: int = 0,
    guard=None,
    step_timeout_s: float = 0.0,
):
    """Train on random windows of ``corpus`` (1-D int array). Returns
    (model, losses), the model updated in place; ``losses`` are this
    call's steps'. A sequence-parallel model takes its mesh from the
    model; the batch is not sharded. Batches derive from ``(seed, step)``.
    ``logit_chunk`` chunks the CE.

    ``checkpoint_dir`` checkpoints every ``checkpoint_every`` steps (0:
    ``steps // 10``, about ten a run) and at the last step; a rerun on the
    directory resumes from its newest intact step. SIGTERM and SIGINT
    stop the loop after the step in flight, and the ``finally`` path
    checkpoints the last completed step, so a preemption loses at most
    the step in flight. The ``train.preempt`` and ``train.sigterm`` fault
    sites, keyed by the step, drill both paths.

    Resilience, as in the JAX package:

    - ``guard`` — a ``GuardConfig``, a mode string (``"skip"``/
      ``"halt"``), or None (→ ``KEYSTONE_GUARD``). ``skip`` leaves the
      model and the optimizer untouched on a non-finite-loss step
      (decided on the device); ``halt`` stops at the next interval check
      and returns the last checkpointed state. The ``train.nan`` fault,
      keyed by the step, NaNs a step's loss and gradients; with no guard
      mode it corrupts what a real bad batch would.
    - ``step_timeout_s`` (or ``KEYSTONE_STEP_TIMEOUT_S``) arms a watchdog
      that logs the thread stacks when a step stops completing;
      ``KEYSTONE_STEP_ESCALATE=N`` hard-aborts the process with the
      watchdog's exit code after N consecutive stalls, for a supervisor
      to replace it. The watchdog thread reads a clock and Python frames
      only, never the card.
    - with an active cluster monitor every completed step is reported to
      the heartbeat thread, saves pass the coordinated barrier, and a
      declared host loss leaves the loop with ``HostLostError`` on the
      last periodic checkpoint (no rescue save: its barrier would wait on
      the dead peer). ``cluster.host_kill``, keyed by the step, SIGKILLs
      the process before that step's periodic save.

    In a process group of several processes, training is data-parallel:
    each process takes its row block of every step's batch, the gradients
    and the loss are all-reduced to their global means, the parameters
    start from process 0's, and a checkpoint is written once, by process
    0, between two barriers. A tensor-parallel model reduces over its
    mesh's data axis only, and its checkpoint holds whole leaves gathered
    over the model axis; a ring or Ulysses model takes the whole batch on
    every rank. In one process a ``mesh`` whose data axis would shard a
    local model's batch trains it on the model's card."""
    from keystone_tpu_torch.resilience import cluster as _cluster
    from keystone_tpu_torch.resilience import faults as _faults
    from keystone_tpu_torch.resilience.guards import (
        LossGuard,
        NumericalHealthError,
        resolve_guard,
    )
    from keystone_tpu_torch.resilience.retry import RetryExhausted

    if len(corpus) < seq + 2:
        raise ValueError(
            f"corpus of {len(corpus)} tokens is too short for seq={seq} "
            f"(needs at least seq+2 = {seq + 2}); shorten --seq or grow "
            "the corpus"
        )
    if has_quantized_leaves(model):
        raise ValueError(
            "model holds int8 QTensor weights (quantize_for_decode is "
            "inference-only) — gradients through the rounding would be "
            "silently zero; train the float model and re-quantize"
        )
    rows = _data_parallel(model=model, batch=batch, mesh=mesh)
    guard_cfg = resolve_guard(guard)
    plan = _faults.active()
    # the guarded step is built only when asked (a guard mode, or an armed
    # train.nan site), so the default loop runs the plain step untouched
    skip_nonfinite = guard_cfg.mode != "off"
    guarded = skip_nonfinite or (plan is not None and plan.has_site("train.nan"))
    optimizer = make_optimizer(lr, steps=steps, schedule=schedule, grad_clip=grad_clip)
    opt_state = optimizer.init(model.leaves())
    if skip_nonfinite:
        opt_state.count = torch.zeros((), dtype=torch.int64, device=model.device)
    step = make_train_step(optimizer, logit_chunk=logit_chunk, guarded=guarded,
                           skip_nonfinite=skip_nonfinite, data_parallel=rows is not None)
    losses = []

    ckpt = None
    every = 0
    if checkpoint_dir:
        from keystone_tpu_torch.core.checkpoint import TrainCheckpointer

        every = checkpoint_every or max(steps // 10, 1)
        ckpt = TrainCheckpointer(
            checkpoint_dir,
            _run_identity(model, corpus, batch=batch, seq=seq, lr=lr, seed=seed,
                          schedule=schedule, grad_clip=grad_clip, logit_chunk=logit_chunk,
                          guarded=(False if not guarded
                                   else ("skip" if skip_nonfinite else "inject"))),
            legacy_defaults=_legacy_defaults(model),
            # informational, not compared: the process set at save time
            cluster_info={
                "num_processes": _cluster.process_count(),
                "mesh": None if mesh is None else {k: int(v) for k, v in mesh.shape.items()},
            },
        )
    if step_timeout_s <= 0:
        step_timeout_s = float(os.environ.get("KEYSTONE_STEP_TIMEOUT_S", "0") or 0)
    loss_guard = LossGuard(guard_cfg)

    # first signal → flag only: the loop stops after the step in flight and
    # the finally path checkpoints. A second signal means the loop is not
    # getting back to its check: the previous handlers are restored and the
    # signal re-delivered, so a repeated Ctrl-C or SIGTERM escalates.
    stop_signal: dict = {"sig": None}
    prev_handlers: dict = {}
    if ckpt is not None and threading.current_thread() is threading.main_thread():

        def _on_signal(signum, frame):
            if stop_signal["sig"] is not None:
                for s, h in prev_handlers.items():
                    signal.signal(s, h)
                prev = prev_handlers.get(signum)
                if callable(prev):
                    prev(signum, frame)
                else:
                    signal.raise_signal(signum)
                return
            stop_signal["sig"] = signum

        for s in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[s] = signal.signal(s, _on_signal)

    dog = None
    if step_timeout_s > 0:
        from keystone_tpu_torch.resilience.watchdog import Watchdog

        # started after the first step completes: the first step builds
        # the kernels and warms the allocator, which would otherwise
        # read as a stall on every run
        escalate = int(os.environ.get("KEYSTONE_STEP_ESCALATE", "0") or 0)
        dog = Watchdog(step_timeout_s, label="lm_train",
                       escalate_after=escalate if escalate > 0 else None)

    # live telemetry: per-step loss / tokens-per-s / MFU into steps.jsonl
    # whenever an observe sink is active, the card's memory watermark, and
    # profiler windows (KEYSTONE_PROFILE_STEPS / SIGUSR2). With no sink,
    # no tuner and no windows a step pays two global reads.
    from keystone_tpu_torch.core.staging import tune_active
    from keystone_tpu_torch.models.lm.model import train_step_flops
    from keystone_tpu_torch.observe import devices as _devices
    from keystone_tpu_torch.observe import telemetry as _telemetry
    from keystone_tpu_torch.observe import tracing as _tracing

    step_flops = train_step_flops(model, batch, seq)
    devmon = _devices.DeviceMemoryMonitor()
    # the autotuner (KEYSTONE_TUNE=1): per-step host-vs-compute walls and
    # token goodput feed its attribution window
    tuner = tune_active()
    tracer = _tracing.StepTracer.from_env(
        install_signal=threading.current_thread() is threading.main_thread(),
        label="lm_train",
    )

    start = completed = last_saved = 0
    halted = cluster_lost = False
    try:
        if ckpt is not None:
            state, start = ckpt.restore(_train_state(model, opt_state))
            _restore_shards(model, opt_state, state)
            if not isinstance(opt_state.count, torch.Tensor):
                opt_state.count = int(state["count"])
            if start > steps:
                raise ValueError(
                    f"{checkpoint_dir} holds a step-{start} checkpoint but this run is "
                    f"only {steps} steps — refusing to return an over-trained model; "
                    "point at a fresh directory"
                )
        completed = last_saved = start
        if rows is not None:
            # every replica starts from the parameters of its data axis's
            # first process
            _broadcast_replicas(model)
        for i in range(start, steps):
            if tracer is not None:
                tracer.step(i)
            t_step0 = time.perf_counter()
            toks = _step_batch(corpus, seed, i, batch, seq)
            if rows is not None:
                toks = toks[rows[0] : rows[1]]
            toks = torch.from_numpy(np.ascontiguousarray(toks)).to(model.device)
            t_host = time.perf_counter() - t_step0
            if guarded:
                model, opt_state, loss = step(model, opt_state, toks,
                                              _faults.fire("train.nan", key=i))
            else:
                model, opt_state, loss = step(model, opt_state, toks)
            # the loss stays on the device: a float() here would wait for
            # the step in every iteration
            losses.append(loss)
            completed = i + 1
            _cluster.note_step(completed)
            steplog = _telemetry.active_step_log()
            if steplog is not None or tuner is not None:
                # the one host read per step the live stream (and honest
                # tuner walls) pays: the wall is taken after it
                loss_f = float(loss)
                wall = time.perf_counter() - t_step0
                if tuner is not None:
                    tuner.observe(
                        rows=batch * seq,
                        buckets={"wait_host": t_host, "compute": max(wall - t_host, 0.0)},
                    )
                if steplog is not None:
                    steplog.step(step=i + 1, loss=loss_f, tokens=batch * seq, wall_s=wall,
                                 flops=step_flops, hbm_peak_bytes=devmon.maybe_sample())
            # one host read per check interval, not per step
            loss_guard.note(i, loss)
            if dog is not None:
                dog.pet() if dog.running else dog.start()
            if log_every and (i + 1) % log_every == 0:
                logger.info("step %d loss %.4f", i + 1, float(loss))
            if _faults.fire("cluster.host_kill", key=i):
                # a dying machine checkpoints nothing and cleans up
                # nothing: SIGKILL is exactly that (before the periodic
                # save, so the drill loses the in-interval steps)
                logger.warning("cluster.host_kill fault at step %d: killing this process", i)
                os.kill(os.getpid(), signal.SIGKILL)
            lost = _cluster.check_lost()
            if lost is not None:
                # before the periodic save: a coordinated save with a
                # known-dead peer can only time out at the barrier
                raise _cluster.HostLostError(lost)
            if ckpt is not None and ((i + 1) % every == 0 or (i + 1) == steps):
                try:
                    ckpt.save(_train_state(model, opt_state), i + 1)
                    last_saved = i + 1
                except (OSError, RetryExhausted) as e:
                    # a full disk at a PERIODIC save must not end the run:
                    # the previous checkpoint is intact (atomic), so go on
                    # loudly and try again at the next interval (a
                    # barrier failure is a membership problem and raises)
                    logger.warning(
                        "periodic checkpoint save at step %d failed (%r); continuing on "
                        "the step-%d checkpoint", i + 1, e, last_saved,
                    )
                    _emit_resilience("ckpt_save_failed", counter="ckpt_save_failures",
                                     step=i + 1, last_saved=last_saved, error=repr(e))
            if _faults.fire("train.sigterm", key=i):
                if prev_handlers:
                    # a real signal to this process: the handler path end to end
                    signal.raise_signal(signal.SIGTERM)
                else:
                    logger.warning(
                        "train.sigterm fault fired at step %d but no handler is "
                        "installed; ignoring", i,
                    )
            if stop_signal["sig"] is not None:
                logger.warning(
                    "signal %d at step %d: writing the final checkpoint and stopping early",
                    stop_signal["sig"], i + 1,
                )
                _emit_resilience("signal_stop", signum=stop_signal["sig"], step=i + 1)
                break
            _faults.maybe_preempt(key=i)
        loss_guard.flush()
    except _cluster.ClusterError as e:
        # a lost peer makes the coordinated rescue save impossible: leave
        # on the last periodic checkpoint; the supervisor resumes there
        cluster_lost = True
        logger.warning("training stopped by cluster membership change at step %d: %s",
                       completed, e)
        _emit_resilience("host_lost_exit", step=completed, error=repr(e))
        raise
    except NumericalHealthError as e:
        # halt with the last good checkpoint: return the last checkpointed
        # state rather than the post-spike one
        halted = True
        logger.warning("training halted by health guard: %s", e)
        _emit_resilience("guard_halt", step=completed, error=repr(e))
        if ckpt is None:
            raise
        state, restored = ckpt.restore(_train_state(model, opt_state))
        _restore_shards(model, opt_state, state)
        if restored == 0:
            # nothing was ever checkpointed: there is no "last good" state
            raise
        losses = losses[: max(restored - start, 0)]
    finally:
        try:
            if ckpt is not None and completed > last_saved and not halted and not cluster_lost:
                # preemption, signal or crash: the periodic save did not
                # cover the last completed step — write it now
                ckpt.save(_train_state(model, opt_state), completed)
                _emit_resilience("final_checkpoint", step=completed)
        except Exception:  # noqa: BLE001 — must not mask the original exception
            logger.exception("final checkpoint save at step %d failed", completed)
        finally:
            if dog is not None:
                dog.stop()
            if tracer is not None:
                tracer.close()
            for s, h in prev_handlers.items():
                signal.signal(s, h)
    if loss_guard.skipped:
        logger.warning("guard skipped %d non-finite step(s): %s",
                       len(loss_guard.skipped), loss_guard.skipped)
    return model, [float(x) for x in losses]


def synthetic_corpus(n: int, vocab: int, seed: int = 0) -> np.ndarray:
    """A learnable-but-not-trivial token stream: an order-1 Markov chain
    with a sparse, deterministic-ish transition structure."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, 4))
    probs = np.array([0.7, 0.15, 0.1, 0.05])
    out = np.empty(n, np.int32)
    out[0] = 0
    choices = rng.choice(4, size=n, p=probs)
    for i in range(1, n):
        out[i] = succ[out[i - 1], choices[i]]
    return out
