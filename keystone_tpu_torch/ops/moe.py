"""Mixture-of-experts FFN — port of ``keystone_tpu/ops/moe.py``.

A GShard-style top-2 routed expert FFN. Routing, dispatch and combine are
einsums over a dense one-hot dispatch tensor: the capacity-factor bound
makes every shape static, so there is no scatter, no ragged shape and no
value read back to the host, and a decode step through the layer can be
captured in a CUDA graph. Tokens over an expert's capacity are dropped
(they add zero; the residual stream carries them).

Expert-parallel over a mesh's model axis (``tp``, from the LM's
``shard_params``), tokens stay whole at every position: each position runs
its own experts on the dispatch that the whole router computed, and the
partial combines add up over the axis. Capacity and routing do not change.

Tokens route within groups of ``group_size``; the last group is padded
with dummies that claim no capacity. The JAX package maps ``_route_group``
over the groups with ``jax.vmap``; here the groups are a leading axis of
every tensor. Each one-hot is a comparison with an ``arange``
(:func:`one_hot`): an index out of range gives a zero row, as
``jax.nn.one_hot`` does, where ``torch.nn.functional.one_hot`` would
refuse it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from keystone_tpu_torch.core.runtime import resolve_device


def one_hot(idx, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: (..., ) int → (..., n), a zero row where ``idx``
    is outside [0, n). A comparison, so it needs no host check."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class MoELayer(nn.Module):
    """Top-2 routed expert FFN: (B, S, d) → (B, S, d) plus the GShard
    load-balance auxiliary loss. ``w_router`` (d, E), ``w1`` (E, d, ff),
    ``w2`` (E, ff, d): float parameters that need no gradient until a
    train step asks for one."""

    def __init__(self, w_router, w1, w2, capacity_factor: float = 1.25,
                 group_size: int = 4096):
        super().__init__()
        self.w_router = nn.Parameter(w_router, requires_grad=False)
        self.w1 = nn.Parameter(w1, requires_grad=False)
        self.w2 = nn.Parameter(w2, requires_grad=False)
        self.capacity_factor = capacity_factor
        self.group_size = group_size

    @property
    def num_experts(self) -> int:
        return self.w_router.shape[-1]

    def leaves(self) -> tuple:
        return (self.w_router, self.w1, self.w2)

    def replace(self, **changes) -> "MoELayer":
        """A layer sharing this one's tensors, with ``changes`` applied."""
        kw = dict(w_router=self.w_router, w1=self.w1, w2=self.w2,
                  capacity_factor=self.capacity_factor, group_size=self.group_size)
        kw.update(changes)
        return MoELayer(**kw)

    @staticmethod
    def create(dim: int, ff: int, num_experts: int, capacity_factor: float = 1.25,
               group_size: int = 4096, *, generator: torch.Generator | None = None,
               device=None) -> "MoELayer":
        """Random weights drawn on ``device`` (the card unless the caller
        asks for the CPU) from ``generator`` (seed 0 when None), by the JAX
        package's recipe, not its bits: router N(0, 0.02²), w1 and w2
        N(0, 1/fan_in)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)

        def normal(shape, std):
            return torch.randn(shape, generator=generator, device=device) * std

        return MoELayer(
            w_router=normal((dim, num_experts), 0.02),
            w1=normal((num_experts, dim, ff), dim**-0.5),
            w2=normal((num_experts, ff, dim), ff**-0.5),
            capacity_factor=capacity_factor,
            group_size=group_size,
        )

    def _capacity(self, num_tokens: int) -> int:
        # top-2: every token wants two slots; at least one slot
        cap = int(math.ceil(2 * num_tokens * self.capacity_factor / self.num_experts))
        return max(cap, 1)

    def forward(self, x, tp=None):
        """x: (B, S, d) → (out (B, S, d), aux loss: an f32 scalar).
        ``tp`` runs the experts expert-parallel over its model axis."""
        b, s, d = x.shape
        g_tot = b * s
        xf = x.reshape(g_tot, d)
        gs = min(self.group_size, g_tot)
        ng = -(-g_tot // gs)
        xp = F.pad(xf, (0, 0, 0, ng * gs - g_tot))
        valid = (torch.arange(ng * gs, device=x.device) < g_tot).reshape(ng, gs)
        outs, auxs, counts = self._route_groups(
            xp.reshape(ng, gs, d), valid, self._capacity(gs), tp
        )
        out = outs.reshape(ng * gs, d)[:g_tot]
        # each group's aux weighted by its real token count
        aux = torch.sum(auxs * counts) / torch.clamp(torch.sum(counts), min=1.0)
        return out.reshape(b, s, d), aux

    def _route_groups(self, xf, valid, c: int, tp=None):
        """Route every group at once. xf: (G, gs, d); valid: (G, gs) bool
        marks real tokens (padding claims no capacity and emits zero).
        Returns (out (G, gs, d), aux (G,), real count (G,))."""
        combine, dispatch, aux, counts = self.dispatch_weights(xf, valid, c)
        if tp is not None:
            return self.experts_parallel(xf, combine, dispatch, tp), aux, counts
        return self.experts(xf, combine, dispatch), aux, counts

    def dispatch_weights(self, xf, valid, c: int):
        """The routing: (combine (G, gs, E, C) f32 weights, dispatch — their
        0/1 support in x's dtype —, aux (G,), real count (G,))."""
        e = self.num_experts
        # routing in f32; the expert products run in x's dtype
        logits = xf.to(torch.float32) @ self.w_router.to(torch.float32)  # (G, gs, E)
        probs = torch.softmax(logits, dim=-1)
        vmask = valid.to(torch.float32)[..., None]  # (G, gs, 1)

        # argmax takes the first of equal values, as jnp.argmax does
        mask1 = one_hot(torch.argmax(probs, dim=-1), e) * vmask
        probs2 = probs * (1.0 - mask1)
        mask2 = one_hot(torch.argmax(probs2, dim=-1), e) * vmask

        # load-balance aux over real tokens, scaled E² (1 at uniform routing)
        count = torch.clamp(torch.sum(vmask, dim=(1, 2)), min=1.0)[:, None]  # (G, 1)
        aux = torch.mean(
            (torch.sum(mask1, dim=1) / count) * (torch.sum(probs * vmask, dim=1) / count),
            dim=-1,
        ) * (e * e)

        # capacity slots: top-1 tokens claim first, top-2 queue behind all
        pos1 = torch.cumsum(mask1, dim=1) * mask1 - mask1  # (G, gs, E)
        count1 = torch.sum(mask1, dim=1, keepdim=True)  # (G, 1, E)
        pos2 = (torch.cumsum(mask2, dim=1) - mask2 + count1) * mask2
        keep1 = mask1 * (pos1 < c)
        keep2 = mask2 * (pos2 < c)

        gate1 = torch.sum(probs * keep1, dim=-1)  # (G, gs)
        gate2 = torch.sum(probs * keep2, dim=-1)
        denom = torch.clamp(gate1 + gate2, min=1e-9)
        gate1, gate2 = gate1 / denom, gate2 / denom

        # a dropped token's slot index is ≥ c: its one-hot row is zero
        slot1 = one_hot(torch.sum(pos1, dim=-1).to(torch.int32), c)  # (G, gs, C)
        slot2 = one_hot(torch.sum(pos2, dim=-1).to(torch.int32), c)
        combine = (
            gate1[..., None, None] * keep1[..., None] * slot1[..., None, :]
            + gate2[..., None, None] * keep2[..., None] * slot2[..., None, :]
        )  # (G, gs, E, C)
        dispatch = (combine > 0.0).to(xf.dtype)
        return combine, dispatch, aux, torch.sum(vmask, dim=(1, 2))

    def experts(self, xf, combine, dispatch, w1=None, w2=None):
        """Dispatch → the expert products → combine, in x's dtype:
        (G, gs, d) → (G, gs, d). ``w1`` and ``w2`` default to every expert's;
        ``combine`` and ``dispatch`` cover the same experts."""
        dt = xf.dtype
        w1 = self.w1 if w1 is None else w1
        w2 = self.w2 if w2 is None else w2
        expert_in = torch.einsum("tgec,tgd->tecd", dispatch, xf)  # (G, E, C, d)
        h = F.gelu(
            torch.einsum("tecd,edf->tecf", expert_in, w1.to(dt)), approximate="tanh"
        )
        expert_out = torch.einsum("tecf,efd->tecd", h, w2.to(dt))
        return torch.einsum("tgec,tecd->tgd", combine.to(dt), expert_out)

    def experts_parallel(self, xf, combine, dispatch, tp):
        """:meth:`experts` with the experts split over ``tp``'s model axis:
        each position takes the tokens, the combine weights and the dispatch
        of its E/n experts, and the partial combines add up over the
        axis."""
        comm = tp.comm
        e_local = self.num_experts // tp.n
        parts = []
        for pos, x, cw in zip(comm.positions, comm.enter(xf), comm.enter(combine)):
            sl = slice(pos * e_local, (pos + 1) * e_local)
            parts.append(self.experts(
                x, cw[:, :, sl], dispatch[:, :, sl].to(x.device),
                tp.part(self.w1, 0, pos, x.device), tp.part(self.w2, 0, pos, x.device),
            ))
        return comm.psum(parts, device=xf.device)
