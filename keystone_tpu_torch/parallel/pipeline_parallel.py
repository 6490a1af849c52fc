"""GPipe-style pipeline parallelism over a mesh axis — port of
``keystone_tpu/parallel/pipeline_parallel.py``.

A chain of equal-width stages runs one stage a position along a mesh axis,
and microbatches stream through the chain with each stage's activation
handed to the next. The schedule has ``M + S − 1`` steps: at step t stage 0
injects microbatch t and stage s runs microbatch t − s, so after the
``S − 1``-step fill every stage computes every step — the GPipe schedule
with bubble fraction ``(S−1)/(S−1+M)``.

The JAX package runs the schedule as one ``shard_map`` over a ``lax.scan``
and takes its backward from AD. The port runs it in one of two ways:

- **one process** (a mesh this process drives): the stages run on their
  positions' devices in turn, activations move with ``tensor.to``, and
  autograd carries the backward;
- **across processes** (one position a rank): each rank runs its own
  stage; a stage's activation is sent to the next stage's rank, and the
  backward is the reverse schedule — receive the output gradient from the
  next stage, backward the stage, send the input gradient to the previous
  stage (:class:`_PipeAcross`).

Either way ``x`` and the stacked parameters come in whole and replicated,
the outputs are collected on the last stage and given to every position,
and their backward takes the last stage's own gradient, not a sum. The
input's gradient comes back from stage 0 to every position, and each
stage's parameter gradient to every position of the axis, so replicated
values keep equal gradients everywhere. ``data_axis`` composes dp × pp:
the microbatches' batch dim is split over it and each data row of
positions pipelines its own slice.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree

from keystone_tpu_torch.parallel.collectives import (
    AxisComm,
    all_gather_cat,
    all_reduce,
    broadcast,
    recv,
    send,
)


#: when a list, the cross-process schedule appends ``(kind, start, end)``
#: CUDA event pairs on a card: ``"stage"`` around each microbatch's stage
#: forward and backward, ``"pipe"`` around the whole forward and the whole
#: backward — the stages' busy share of the pipe, whose complement is the
#: bubble. None (the default) records nothing.
STAGE_EVENTS: list | None = None


@contextlib.contextmanager
def _span(kind: str, device):
    if STAGE_EVENTS is None or torch.device(device).type != "cuda":
        yield
        return
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    try:
        yield
    finally:
        end.record()
        STAGE_EVENTS.append((kind, start, end))


def _check_stages(leaves_with_path, n_stages: int, axis: str) -> None:
    for path, leaf in leaves_with_path:
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stacked param {pytree.keystr(path)} has "
                f"{leaf.shape[0]} stages on its leading axis; pipeline "
                f"axis {axis!r} has {n_stages} devices"
            )


def _stage_params(leaves, spec, s: int, device):
    return pytree.tree_unflatten([leaf[s].to(device) for leaf in leaves], spec)


def _schedule(stage_fn, params, xs, devices, out_device):
    """The GPipe schedule of one pipeline in one process: ``params[s]`` is
    stage s's parameter tree on ``devices[s]``; ``xs`` is (M, ...). Returns
    the last stage's outputs stacked, on ``out_device``."""
    n_stages, m = len(devices), xs.shape[0]
    handed = [None] * n_stages  # stage s's output of the previous step
    outs = [None] * m
    for t in range(m + n_stages - 1):
        # last stage first: stage s reads what stage s − 1 handed over at
        # step t − 1 before stage s − 1 overwrites it
        for s in reversed(range(n_stages)):
            mb = t - s
            if not 0 <= mb < m:
                continue
            inp = xs[mb].to(devices[0]) if s == 0 else handed[s - 1]
            y = stage_fn(params[s], inp)
            if s == n_stages - 1:
                outs[mb] = y.to(out_device)
            else:
                handed[s] = y.to(devices[s + 1])
    return torch.stack(outs)


class _PipeAcross(torch.autograd.Function):
    """This rank's stage of a pipeline whose stages are processes. Inputs:
    the run's settings, the whole microbatched ``x`` (M, B, ...) and the
    stacked parameter leaves; output: the whole (M, B, ...) chain output
    on every rank."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        stage, n_stages = run["pipe"].index, run["pipe"].size
        lo, hi = run["rows"]
        xs = x[:, lo:hi]
        x_grad, leaf_grad = ctx.needs_input_grad[1], ctx.needs_input_grad[2:]
        params = [leaf[stage].detach().requires_grad_(g) for leaf, g in zip(leaves, leaf_grad)]
        tree = pytree.tree_unflatten(params, run["spec"])
        saved, outs = [], []
        with _span("pipe", x.device):
            for mb in range(xs.shape[0]):
                if stage == 0:
                    inp = xs[mb].detach()
                else:
                    inp = recv(xs[mb], run["pipe"], stage - 1)
                inp.requires_grad_(stage > 0 or x_grad)
                with torch.enable_grad(), _span("stage", x.device):
                    y = run["stage_fn"](tree, inp)
                if stage < n_stages - 1:
                    send(y.detach(), run["pipe"], stage + 1)
                else:
                    outs.append(y.detach())
                saved.append((inp, y))
            out = torch.stack(outs) if outs else torch.empty_like(xs)
            # collected on the last stage, given to every stage and data row
            out = broadcast(out, run["pipe"], n_stages - 1)
            if run["data"] is not None:
                out = all_gather_cat(out, run["data"], 1)
        ctx.run, ctx.saved, ctx.params = run, saved, params
        ctx.x_shape, ctx.x_dtype, ctx.x_grad = x.shape, x.dtype, x_grad
        ctx.leaf_shapes = [leaf.shape for leaf in leaves]
        return out

    @staticmethod
    def backward(ctx, g):
        run, saved, params = ctx.run, ctx.saved, ctx.params
        stage, n_stages = run["pipe"].index, run["pipe"].size
        lo, hi = run["rows"]
        gs = g[:, lo:hi]
        want = [p for p in params if p.requires_grad]
        p_grads = [torch.zeros_like(p) for p in want]
        dx = torch.zeros(ctx.x_shape, dtype=ctx.x_dtype, device=g.device)
        with _span("pipe", g.device):
            for mb in reversed(range(len(saved))):
                inp, y = saved[mb]
                # the last stage takes its own gradient of the replicated output
                gy = gs[mb] if stage == n_stages - 1 else recv(y, run["pipe"], stage + 1)
                needs = ([inp] if inp.requires_grad else []) + want
                with _span("stage", g.device):
                    grads = torch.autograd.grad(y, needs, gy, allow_unused=True)
                if inp.requires_grad:
                    d_inp, grads = grads[0], grads[1:]
                    if stage > 0:
                        send(d_inp, run["pipe"], stage - 1)
                    else:
                        dx[mb, lo:hi] = d_inp
                for acc, gr in zip(p_grads, grads):
                    if gr is not None:
                        acc += gr
        ctx.saved = None
        # the input's gradient from stage 0, each stage's parameter
        # gradient, summed over the data rows and given to every stage
        groups = [grp for grp in (run["data"], run["pipe"]) if grp is not None]
        if ctx.x_grad:
            for grp in groups:
                dx = all_reduce(dx, grp)
        else:
            dx = None
        leaf_grads = []
        it = iter(p_grads)
        for p, shape in zip(params, ctx.leaf_shapes):
            if not p.requires_grad:
                leaf_grads.append(None)
                continue
            full = torch.zeros(shape, dtype=p.dtype, device=p.device)
            full[stage] = next(it)
            for grp in groups:
                full = all_reduce(full, grp)
            leaf_grads.append(full)
        return (None, dx, *leaf_grads)


def gpipe(
    stage_fn,
    stacked_params,
    x,
    mesh,
    *,
    axis: str = "model",
    n_micro: int | None = None,
    data_axis: str | None = None,
):
    """Apply a pipeline of stages to microbatched input.

    ``stage_fn(params, act) -> act`` — one stage's computation; every
    stage must preserve the activation shape and dtype (equal-width
    chain). ``stacked_params`` — pytree (dicts, lists, tuples) whose
    leaves have leading axis ``n_stages``; stage s runs on position s of
    ``axis``. ``x`` — (n_micro, B, ...) microbatches, or (N, ...) with
    ``n_micro`` given to split the batch evenly.

    ``data_axis`` composes dp × pp: the per-microbatch batch dim (axis 1)
    is split over it, so each data row of positions pipelines its own
    batch slice instead of replicating the whole batch (None = replicate,
    the single-row behavior).

    Returns the chain output with the microbatch structure of ``x``,
    whole on every position (the reference's replicated result)."""
    n_stages = mesh.shape[axis]
    reshaped = False
    if n_micro is not None and (x.ndim == 0 or x.shape[0] != n_micro):
        n = x.shape[0]
        if n % n_micro:
            raise ValueError(f"batch {n} not divisible by n_micro={n_micro}")
        x = x.reshape(n_micro, n // n_micro, *x.shape[1:])
        reshaped = True

    with_path, spec = pytree.tree_flatten_with_path(stacked_params)
    _check_stages(with_path, n_stages, axis)
    leaves = [leaf for _, leaf in with_path]

    n_data = 1
    if data_axis is not None:
        n_data = mesh.shape[data_axis]
        if x.ndim < 2:
            raise ValueError(
                f"data_axis={data_axis!r} needs microbatches with a batch "
                f"dim to shard — got rank-{x.ndim} input"
            )
        if x.shape[1] % n_data:
            raise ValueError(
                f"microbatch batch dim {x.shape[1]} not divisible by "
                f"data axis {data_axis!r} ({n_data})"
            )
    pipe = AxisComm.of(mesh, axis)
    if pipe.across:
        data = None
        rows = (0, x.shape[1])
        if data_axis is not None:
            data = AxisComm.of(mesh, data_axis).group
            if data is not None:
                block = x.shape[1] // n_data
                rows = (data.index * block, (data.index + 1) * block)
        run = {"stage_fn": stage_fn, "spec": spec, "pipe": pipe.group, "data": data,
               "rows": rows}
        out = _PipeAcross.apply(run, x, *leaves)
    else:
        rows = x.chunk(n_data, dim=1)
        outs = []
        for i, xs in enumerate(rows):
            devices = _line_devices(mesh, axis, data_axis, i)
            params = [_stage_params(leaves, spec, s, dev) for s, dev in enumerate(devices)]
            outs.append(_schedule(stage_fn, params, xs, devices, x.device))
        out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    if reshaped:
        out = out.reshape(-1, *out.shape[2:])
    return out


def _line_devices(mesh, axis: str, data_axis: str | None, row: int) -> list:
    """The devices along ``axis`` at data index ``row`` (index 0 of every
    other axis) of a one-process mesh."""
    grid = mesh.grid
    index = [0] * grid.ndim
    index[mesh.axis_names.index(axis)] = slice(None)
    if data_axis is not None:
        index[mesh.axis_names.index(data_axis)] = row
    return list(grid[tuple(index)])
