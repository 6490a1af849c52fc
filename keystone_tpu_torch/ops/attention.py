"""Attention, dense and sequence-parallel over a mesh — port of
``keystone_tpu/ops/attention.py``.

- :func:`dense_attention` — the single-device reference, and the CPU path
  of the LM's ``auto`` local attention.
- :func:`ring_attention` — the sequence axis split over the devices along
  one mesh axis. Each position keeps its query shard while the K/V shards
  travel around the ring, and an online softmax accumulates over the hops.
  With ``use_flash`` each hop is kernel K3 (:func:`flash_attention_step`).
  ``trainable`` adds the JAX package's ring backward: the K/V shards
  travel a second time with their dk/dv accumulators.
- :func:`ulysses_attention` — seq→heads resharding, full-sequence local
  attention over H/n heads per position (kernel K2 with ``use_flash``),
  heads→seq back.

The JAX package runs the per-position bodies under ``shard_map``, one
program on every device, whose boundary takes and returns whole,
replicated tensors. The port keeps that boundary and runs the positions
through :class:`~keystone_tpu_torch.parallel.collectives.AxisComm`:

- on a one-process mesh, one process loops over the positions in turn,
  and a collective becomes copies between the positions' devices —
  ``ppermute`` is ``tensor.to(next_device)``, the tiled ``all_to_all`` is
  splits and concatenations. Where two positions name the same device (a
  mesh of one card named n times) the copy is no copy;
- on a mesh across processes, each rank takes its sequence shard of the
  replicated q, k and v, a ring hop is a send and a receive between cards
  (``batch_isend_irecv``), Ulysses' reshardings are ``all_to_all``s, and
  the output is all-gathered; the backward all-gathers dq, dk and dv, so
  the parameter gradients come out the same on every rank.

Both are exact (equal to dense attention up to summation order).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from keystone_tpu_torch.ops.flash_attention import (
    _NEG,
    _bwd_block,
    _grads_rect,
    flash_attention,
    flash_attention_step,
    flash_attention_trainable,
)
from keystone_tpu_torch.parallel.collectives import AxisComm
from keystone_tpu_torch.parallel.mesh import current_mesh


def dense_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Reference multi-head attention. q, k, v: (B, H, S, D). The causal
    mask is END-aligned (``tril`` with diagonal ``S_k − S_q``) and masks
    with −inf, so a fully masked row is NaN — as in the JAX package."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _check_seq_divisible(q, mesh, seq_axis: str) -> None:
    """Loud precondition shared by ring and Ulysses."""
    n = mesh.shape[seq_axis]
    if q.shape[2] % n:
        raise ValueError(
            f"sequence length {q.shape[2]} not divisible by the "
            f"{seq_axis!r} axis ({n} devices)"
        )


def _resolve_mesh(mesh):
    """``mesh``, else the ambient mesh of :func:`use_mesh`; raises when
    there is neither."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh=... or install one with use_mesh(...)")
    return mesh


def _flash_default(devices) -> bool:
    """The fused kernels by default when a position of the mesh is a card —
    the counterpart of the JAX package's ``on_tpu()``. It reads the
    positions' devices, not q's: the shards run where the mesh puts them."""
    return any(torch.device(d).type == "cuda" for d in devices)


def _ring_fwd_state(qs, ks, vs, comm: AxisComm, *, causal: bool, use_flash: bool):
    """Ring forward over the shards of ``comm``'s positions. Returns
    ([out_j], [lse_j]): lse is the row logsumexp of the full masked score
    matrix, (B, H, S_local) f32; fully masked rows carry −1e30.

    Positions run one after another at each hop, in hop order, so every
    position's step of a hop is queued before the K/V blocks move on. With
    the fused kernel a causal hop whose block comes from a later position
    is not launched: n(n+1)/2 steps over the ring instead of n², the same
    state."""
    n = comm.n
    devices = comm.devices
    b, h, s_local, d = qs[0].shape
    f32 = torch.float32

    if use_flash:
        state = [
            (
                torch.full((b, h, s_local), _NEG, dtype=f32, device=dev),
                torch.zeros((b, h, s_local), dtype=f32, device=dev),
                torch.zeros((b, h, s_local, d), dtype=f32, device=dev),
            )
            for dev in devices
        ]
        k_blk, v_blk = ks, vs
        for step in range(n):
            for i, j in enumerate(comm.positions):
                owner = (j - step) % n
                if causal and owner > j:
                    # the block lies wholly after this q window: no live
                    # key, and K3 would return the state bit for bit
                    continue
                state[i] = flash_attention_step(
                    qs[i], k_blk[i], v_blk[i], *state[i],
                    q_offset=j * s_local, k_offset=owner * s_local, causal=causal,
                )
            if step + 1 < n:
                k_blk, v_blk = comm.hop(k_blk, v_blk)
        outs, lses = [], []
        for q, (m, l, acc) in zip(qs, state):
            den = torch.clamp_min(l, 1e-30)
            outs.append((acc / den[..., None]).to(q.dtype))
            lses.append(m + torch.log(den))
        return outs, lses

    # softmax state in f32 whatever q's dtype, as in the JAX package
    scale = 1.0 / math.sqrt(d)
    state = [
        (
            torch.full((b, h, s_local, 1), -math.inf, dtype=f32, device=dev),
            torch.zeros((b, h, s_local, 1), dtype=f32, device=dev),
            torch.zeros((b, h, s_local, d), dtype=f32, device=dev),
        )
        for dev in devices
    ]
    k_blk, v_blk = ks, vs
    for step in range(n):
        for i, j in enumerate(comm.positions):
            owner = (j - step) % n
            m, l, acc = state[i]
            dev = devices[i]
            scores = (qs[i].to(f32) @ k_blk[i].to(f32).transpose(-1, -2)) * scale
            if causal:
                q_pos = j * s_local + torch.arange(s_local, device=dev)
                k_pos = owner * s_local + torch.arange(s_local, device=dev)
                scores = scores.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), -math.inf)
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            # guard fully masked rows (m_new = −inf): exp(−inf − −inf) is NaN
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(scores - m_safe)
            p = torch.where(torch.isfinite(scores), p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = p.to(v_blk[i].dtype).to(f32) @ v_blk[i].to(f32)
            state[i] = (m_new, l, acc * alpha + pv)
        if step + 1 < n:
            k_blk, v_blk = comm.hop(k_blk, v_blk)
    outs, lses = [], []
    for q, (m, l, acc) in zip(qs, state):
        outs.append((acc / torch.clamp_min(l, 1e-30)).to(q.dtype))
        m0, l0 = m[..., 0], l[..., 0]
        lses.append(torch.where(
            torch.isfinite(m0), m0 + torch.log(torch.clamp_min(l0, 1e-30)), _NEG
        ))
    return outs, lses


def _ring_forward(q, k, v, comm: AxisComm, causal: bool, use_flash: bool):
    """(out, lse) of the ring over ``comm``'s positions, both on q's
    device. q, k and v are this process's part of the sequence: whole in
    one process, the rank's shard across processes."""
    outs, lses = _ring_fwd_state(
        *(comm.split_local(x, 2) for x in (q, k, v)), comm, causal=causal, use_flash=use_flash,
    )
    return comm.join_local(outs, 2, q.device), comm.join_local(lses, 2, q.device)


def _ring_backward(q, k, v, out, lse, g, comm: AxisComm, causal: bool):
    """The JAX package's ring backward. Each position keeps its q, out, g
    and lse shards; every K/V shard travels the ring once more with its
    f32 dk/dv accumulators. Per hop a position recomputes that rectangle's
    probabilities from (q, k, lse) with :func:`_grads_rect`, adds dq
    locally and dk/dv into the travelling accumulators; a causal hop whose
    block comes from a later position has no live key and is skipped. One
    last rotation brings every accumulator home. Returns (dq, dk, dv) in
    the inputs' dtypes, on q's device, over this process's part of the
    sequence."""
    n = comm.n
    devices = comm.devices
    qs, ks, vs, outs, gs, lses = (comm.split_local(x, 2) for x in (q, k, v, out, g, lse))
    b, h, s_local, d = qs[0].shape
    f32 = torch.float32
    qf = [x.to(f32) for x in qs]
    gf = [x.to(f32) for x in gs]
    delta = [torch.sum(gx * o.to(f32), dim=-1) for gx, o in zip(gf, outs)]
    bwd_block = _bwd_block()
    blk = bwd_block if s_local > bwd_block else -(-s_local // 8) * 8
    pad = -(-s_local // blk) * blk - s_local

    dq = [torch.zeros((b, h, s_local, d), dtype=f32, device=dev) for dev in devices]
    dk_blk = [torch.zeros_like(x) for x in dq]
    dv_blk = [torch.zeros_like(x) for x in dq]
    k_blk, v_blk = ks, vs
    for step in range(n):
        for i, j in enumerate(comm.positions):
            owner = (j - step) % n
            if causal and owner > j:
                continue
            k_off = owner * s_local
            kp = torch.nn.functional.pad(k_blk[i].to(f32), (0, 0, 0, pad))
            vp = torch.nn.functional.pad(v_blk[i].to(f32), (0, 0, 0, pad))
            dq_c, dk_c, dv_c = _grads_rect(
                qf[i], kp, vp, gf[i], delta[i], lses[i], j * s_local, k_off + s_local,
                causal, blk, k_off=k_off,
            )
            dq[i] += dq_c
            dk_blk[i] += dk_c[:, :, :s_local]
            dv_blk[i] += dv_c[:, :, :s_local]
        if step + 1 < n:
            k_blk, v_blk, dk_blk, dv_blk = comm.hop(k_blk, v_blk, dk_blk, dv_blk)
    # after n − 1 rotations shard s (with its gradients) sits on position
    # s − 1; one more brings every accumulator home
    dk_blk, dv_blk = comm.hop(dk_blk, dv_blk)
    return tuple(
        comm.join_local(parts, 2, ref.device).to(ref.dtype)
        for parts, ref in ((dq, q), (dk_blk, k), (dv_blk, v))
    )


class _RingTrainable(torch.autograd.Function):
    """The ring forward, keeping (q, k, v, out, lse) for the ring
    backward (:func:`_ring_backward`): memory O(S·d), never an (S, S)
    tensor."""

    @staticmethod
    def forward(ctx, q, k, v, comm, causal, use_flash):
        out, lse = _ring_forward(q, k, v, comm, causal, use_flash)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.comm, ctx.causal = comm, causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_backward(q, k, v, out, lse, g.contiguous(), ctx.comm, ctx.causal)
        return (*grads, None, None, None)


def ring_attention(
    q,
    k,
    v,
    mesh=None,
    *,
    seq_axis: str = "data",
    causal: bool = False,
    use_flash: bool | None = None,
    trainable: bool = False,
):
    """Exact attention with the sequence axis split over ``seq_axis``.

    q, k, v: (B, H, S, D), S divisible by the axis size; ``mesh``
    defaults to the ambient one (:func:`use_mesh`). ``use_flash`` runs
    each hop as kernel K3 (default: on when a position is a card); otherwise
    each hop is plain torch with p rounded to v's dtype before the PV
    product. ``trainable`` makes it differentiable with the JAX package's
    ring backward (dk/dv accumulators travelling the ring), the forward
    unchanged. Returns (B, H, S, D) in q's dtype, on q's device."""
    mesh = _resolve_mesh(mesh)
    comm = AxisComm.of(mesh, seq_axis)
    if use_flash is None:
        use_flash = _flash_default(comm.devices)
    _check_seq_divisible(q, mesh, seq_axis)
    if comm.across:
        # the shard_map boundary: this rank's shard in, the whole out
        q, k, v = (comm.scatter(x, 2)[0] for x in (q, k, v))
    if trainable:
        out = _RingTrainable.apply(q, k, v, comm, causal, use_flash)
    else:
        out = _ring_forward(q, k, v, comm, causal, use_flash)[0]
    return comm.gather([out], 2) if comm.across else out


def _ulysses_shard(qs, ks, vs, comm: AxisComm, *, causal: bool, use_flash: bool,
                   trainable: bool = False) -> list:
    """All-to-all sequence↔head resharding (DeepSpeed-Ulysses style).

    In: shard j (B, H, S/n, D) at position j → seq_to_heads, the tiled
    ``all_to_all(split_axis=1, concat_axis=2)`` → (B, H/n, S, D): heads
    j·H/n.. over the full sequence → local attention (K2 with
    ``use_flash``, dense otherwise) → heads_to_seq, ``all_to_all(split
    2, concat 1)``, back to (B, H, S/n, D)."""
    qh, kh, vh = (comm.all_to_all(x, 1, 2) for x in (qs, ks, vs))
    outs = []
    for q, k, v in zip(qh, kh, vh):
        if use_flash and trainable:
            outs.append(flash_attention_trainable(q, k, v, causal))
        elif use_flash:
            outs.append(flash_attention(q, k, v, causal=causal))
        else:
            outs.append(dense_attention(q, k, v, causal=causal))
    return comm.all_to_all(outs, 2, 1)


def ulysses_attention(
    q,
    k,
    v,
    mesh=None,
    *,
    seq_axis: str = "data",
    causal: bool = False,
    use_flash: bool | None = None,
    trainable: bool = False,
):
    """Exact attention via all-to-all head/sequence resharding. Requires H
    divisible by the axis size; ``mesh`` defaults to the ambient one.
    ``use_flash`` runs K2 per position (default: on when a position is a
    card); ``trainable`` takes the flash trainable wrapper. Returns (B, H,
    S, D) in q's dtype, on q's device."""
    mesh = _resolve_mesh(mesh)
    comm = AxisComm.of(mesh, seq_axis)
    if use_flash is None:
        use_flash = _flash_default(comm.devices)
    n = mesh.shape[seq_axis]
    if q.shape[1] % n:
        raise ValueError(f"heads ({q.shape[1]}) not divisible by axis ({n})")
    _check_seq_divisible(q, mesh, seq_axis)
    outs = _ulysses_shard(
        *(comm.scatter(x, 2) for x in (q, k, v)), comm,
        causal=causal, use_flash=use_flash, trainable=trainable,
    )
    return comm.gather(outs, 2, device=q.device)
