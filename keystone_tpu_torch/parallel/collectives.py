"""Collectives with the gradients that tensor, pipeline and sequence
parallelism need, and the positions of one mesh axis as one process runs
them.

Across processes (one card a process) each rank holds one position of an
axis, and a collective runs over that axis's process group
(:meth:`~keystone_tpu_torch.parallel.mesh.Mesh.axis_group`): NCCL between
cards, gloo on the CPU, and gloo stages a card's tensor through the host.
Four autograd functions carry the gradients the JAX package's AD derives
for its collectives:

- :func:`copy_to` — identity forward, all-reduce backward: a replicated
  value entering a column-parallel product, whose gradient each rank holds
  only in part;
- :func:`reduce_from` — all-reduce forward, identity backward: the partial
  sums of a row-parallel product, whose replicated result every rank then
  differentiates alike;
- :func:`gather_from` — all-gather forward, "keep my slice" backward, and
  its dual :func:`scatter_to` — keep my slice forward, all-gather backward:
  the boundary of a sequence-parallel body, which takes and returns whole,
  replicated tensors;
- :func:`all_to_all` — the tiled ``all_to_all``, whose backward is the
  ``all_to_all`` the other way.

``torch.distributed.nn.functional``'s ``all_reduce`` all-reduces its
gradient and its ``all_gather`` reduce-scatters it: for a loss that every
rank of the group computes alike, both multiply the gradients by the
group's size, so neither is used here. :func:`shift` is the ring's hop
(``ppermute`` j → j+1) through ``batch_isend_irecv``.

In one process, :class:`AxisComm` runs every position of the axis itself:
the same collectives are sums, concatenations and copies between the
positions' devices, which autograd differentiates as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.autograd import Function


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's line along one mesh axis: the process group (None: the
    default group of every rank), its ranks in axis order and this rank's
    index among them."""

    pg: Any
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def _dist():
    import torch.distributed as dist

    return dist


def _staged(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``t`` as the group's backend can move it: gloo stages a card's
    tensor through the host."""
    t = t.contiguous()
    if t.device.type != "cpu" and _dist().get_backend(group.pg) == "gloo":
        return t.cpu()
    return t


def all_reduce(t: torch.Tensor, group: AxisGroup, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced (``sum`` or ``max``) over the group."""
    dist = _dist()
    buf = _staged(t, group)
    if buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=group.pg)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along
    ``dim`` in axis order."""
    buf = _staged(t, group)
    outs = [torch.empty_like(buf) for _ in range(group.size)]
    _dist().all_gather(outs, buf, group=group.pg)
    return torch.cat(outs, dim=dim).to(t.device)


def all_to_all_cat(t: torch.Tensor, group: AxisGroup, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
    """The tiled ``all_to_all``: ``t`` split along ``split_dim`` into one
    chunk per rank, chunk c sent to rank c, and the chunks received from
    every rank concatenated along ``cat_dim`` in axis order."""
    n = group.size
    send = _staged(torch.stack(t.chunk(n, dim=split_dim)), group)
    recv = torch.empty_like(send)
    _dist().all_to_all_single(recv, send, group=group.pg)
    return torch.cat(list(recv.unbind(0)), dim=cat_dim).to(t.device)


def broadcast(t: torch.Tensor, group: AxisGroup, src: int) -> torch.Tensor:
    """A new tensor on every rank: the value of ``t`` at axis index
    ``src``."""
    buf = _staged(t, group)
    if buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    _dist().broadcast(buf, src=group.ranks[src], group=group.pg)
    return buf.to(t.device)


def send(t: torch.Tensor, group: AxisGroup, dst: int) -> None:
    """Send ``t`` to axis index ``dst``."""
    _dist().send(_staged(t, group), dst=group.ranks[dst], group=group.pg)


def recv(like: torch.Tensor, group: AxisGroup, src: int) -> torch.Tensor:
    """A tensor shaped like ``like``, received from axis index ``src``."""
    buf = _staged(torch.empty_like(like), group)
    _dist().recv(buf, src=group.ranks[src], group=group.pg)
    return buf.to(like.device)


def shift(tensors, group: AxisGroup) -> list:
    """The ring's hop, ``ppermute`` with ``perm j → j+1``: each tensor sent
    to the next index and its counterpart received from the previous one,
    in one ``batch_isend_irecv``."""
    dist = _dist()
    n, j = group.size, group.index
    nxt, prev = group.ranks[(j + 1) % n], group.ranks[(j - 1) % n]
    outs, bufs, ops = [], [], []
    for t in tensors:
        buf = _staged(t, group)
        into = torch.empty_like(buf)
        ops += [dist.P2POp(dist.isend, buf, nxt, group.pg),
                dist.P2POp(dist.irecv, into, prev, group.pg)]
        bufs.append(buf)
        outs.append((into, t.device))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [into.to(dev) for into, dev in outs]


class _CopyTo(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        mine = g.chunk(ctx.group.size, dim=ctx.dim)[ctx.group.index]
        return mine.contiguous(), None, None


class _ScatterTo(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(group.size, dim=dim)[group.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.dims = group, (split_dim, cat_dim)
        return all_to_all_cat(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return all_to_all_cat(g, ctx.group, cat_dim, split_dim), None, None, None


def copy_to(x, group: AxisGroup):
    """Identity forward, all-reduce backward."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group: AxisGroup):
    """All-reduce (sum) forward, identity backward."""
    return _ReduceFrom.apply(x, group)


def gather_from(x, group: AxisGroup, dim: int):
    """All-gather along ``dim`` forward; the backward keeps this rank's
    slice."""
    return _GatherFrom.apply(x, group, dim)


def scatter_to(x, group: AxisGroup, dim: int):
    """This rank's slice along ``dim`` forward; the backward all-gathers."""
    return _ScatterTo.apply(x, group, dim)


def all_to_all(x, group: AxisGroup, split_dim: int, cat_dim: int):
    """The tiled ``all_to_all`` (see :func:`all_to_all_cat`), differentiable."""
    return _AllToAll.apply(x, group, split_dim, cat_dim)


class AxisComm:
    """The positions of one mesh axis that this process runs, and the
    collectives over the whole axis. Across processes it is one position
    (this rank's) and the axis's process group; in one process it is every
    position, each on its own device, and the collectives move values
    between them.

    Lists of per-position values go in and out in ``positions`` order: one
    entry across processes, ``n`` in one process."""

    def __init__(self, n: int, positions: list, devices: list, group: AxisGroup | None = None):
        self.n = n
        self.positions = list(positions)
        self.devices = [torch.device(d) for d in devices]
        self.group = group

    @staticmethod
    def of(mesh, axis: str) -> "AxisComm":
        n = mesh.shape[axis]
        if mesh.spans_processes:
            from keystone_tpu_torch.parallel import multihost

            group = mesh.axis_group(axis)
            index = 0 if group is None else group.index
            return AxisComm(n, [index], [multihost.local_device()], group)
        return AxisComm(n, list(range(n)), mesh.axis_devices(axis))

    @property
    def across(self) -> bool:
        """True when the axis's positions are other processes."""
        return self.group is not None

    def enter(self, x) -> list:
        """A replicated value at every position (:func:`copy_to`)."""
        if self.across:
            return [copy_to(x, self.group)]
        return [x.to(d) for d in self.devices]

    def psum(self, parts, device=None):
        """The sum over the axis, replicated (:func:`reduce_from`); in one
        process, on ``device`` (default: the first position's), summed in
        position order."""
        if self.across:
            return reduce_from(parts[0], self.group)
        home = device or self.devices[0]
        out = parts[0].to(home)
        for p in parts[1:]:
            out = out + p.to(home)
        return out

    def pmax(self, parts, device=None):
        """The element-wise max over the axis, outside autograd."""
        if self.across:
            return all_reduce(parts[0].detach(), self.group, op="max")
        home = device or self.devices[0]
        out = parts[0].detach().to(home)
        for p in parts[1:]:
            out = torch.maximum(out, p.detach().to(home))
        return out

    def gather(self, parts, dim: int, device=None):
        """The positions' values concatenated along ``dim``
        (:func:`gather_from`)."""
        if self.across:
            return gather_from(parts[0], self.group, dim)
        home = device or self.devices[0]
        return torch.cat([p.to(home) for p in parts], dim=dim)

    def scatter(self, x, dim: int) -> list:
        """Each position's slice of a replicated ``x`` along ``dim``
        (:func:`scatter_to`)."""
        if self.across:
            return [scatter_to(x, self.group, dim)]
        return [c.to(d).contiguous() for c, d in zip(x.chunk(self.n, dim=dim), self.devices)]

    def all_to_all(self, parts, split_dim: int, cat_dim: int) -> list:
        """The tiled ``all_to_all``: position j gathers chunk j (along
        ``split_dim``) of every position's value, concatenated along
        ``cat_dim`` in position order."""
        if self.across:
            return [all_to_all(parts[0], self.group, split_dim, cat_dim)]
        return [
            torch.cat([x.chunk(self.n, dim=split_dim)[j].to(dev) for x in parts],
                      dim=cat_dim).contiguous()
            for j, dev in enumerate(self.devices)
        ]

    def split_local(self, x, dim: int) -> list:
        """This process's positions' pieces of ``x`` along ``dim``: the
        whole axis's value split over the positions in one process, the
        rank's own piece as it is across processes."""
        if self.across:
            return [x.contiguous()]
        return [c.to(d).contiguous() for c, d in zip(x.chunk(self.n, dim=dim), self.devices)]

    def join_local(self, parts, dim: int, device):
        """The inverse of :meth:`split_local`, on ``device``."""
        if self.across:
            return parts[0].to(device)
        return torch.cat([p.to(device) for p in parts], dim=dim)

    def hop(self, *lists) -> tuple:
        """``ppermute`` j → j+1 of each list of per-position values:
        position j receives what position j−1 held."""
        if self.across:
            moved = shift([lst[0] for lst in lists], self.group)
            return tuple([m] for m in moved)
        n = self.n
        return tuple(
            [lst[(j - 1) % n].to(self.devices[j], non_blocking=True) for j in range(n)]
            for lst in lists
        )
