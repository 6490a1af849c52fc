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
program on every device. The port is single-controller as JAX is: one
process loops over the positions of :class:`Mesh` in turn, and a
collective becomes copies between the positions' devices — ``ppermute``
is ``tensor.to(next_device)``, the tiled ``all_to_all`` is splits and
concatenations. Where two positions name the same device (a mesh of one
card named n times) the copy is no copy. Both are exact (equal to dense
attention up to summation order).
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
    if mesh.spans_processes:
        raise NotImplementedError(
            "ring and Ulysses attention over a mesh across processes: sequence "
            "parallelism over processes is ROADMAP A6 part 2"
        )
    return mesh


def _flash_default(devices) -> bool:
    """The fused kernels by default when a position of the mesh is a card —
    the counterpart of the JAX package's ``on_tpu()``. It reads the
    positions' devices, not q's: the shards run where the mesh puts them."""
    return any(torch.device(d).type == "cuda" for d in devices)


def _shards(x, devices) -> list:
    """``x`` split along the sequence axis, shard j contiguous on
    ``devices[j]``."""
    return [
        c.to(dev).contiguous() for c, dev in zip(x.chunk(len(devices), dim=2), devices)
    ]


def _ring_hop(blocks, devices) -> list:
    """``ppermute`` with ``perm j → j+1``: position j receives what
    position j−1 held."""
    n = len(devices)
    return [blocks[(j - 1) % n].to(devices[j], non_blocking=True) for j in range(n)]


def _ring_fwd_state(qs, ks, vs, devices, *, causal: bool, use_flash: bool):
    """Ring forward over per-position shards. Returns ([out_j], [lse_j]):
    lse is the row logsumexp of the full masked score matrix, (B, H,
    S_local) f32; fully masked rows carry −1e30.

    Positions run one after another at each hop, in hop order, so every
    position's step of a hop is queued before the K/V blocks move on. With
    the fused kernel a causal hop whose block comes from a later position
    is not launched: n(n+1)/2 steps instead of n², the same state."""
    n = len(devices)
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
            for j in range(n):
                owner = (j - step) % n
                if causal and owner > j:
                    # the block lies wholly after this q window: no live
                    # key, and K3 would return the state bit for bit
                    continue
                state[j] = flash_attention_step(
                    qs[j], k_blk[j], v_blk[j], *state[j],
                    q_offset=j * s_local, k_offset=owner * s_local, causal=causal,
                )
            if step + 1 < n:
                k_blk, v_blk = _ring_hop(k_blk, devices), _ring_hop(v_blk, devices)
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
        for j in range(n):
            owner = (j - step) % n
            m, l, acc = state[j]
            dev = devices[j]
            scores = (qs[j].to(f32) @ k_blk[j].to(f32).transpose(-1, -2)) * scale
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
            pv = p.to(v_blk[j].dtype).to(f32) @ v_blk[j].to(f32)
            state[j] = (m_new, l, acc * alpha + pv)
        if step + 1 < n:
            k_blk, v_blk = _ring_hop(k_blk, devices), _ring_hop(v_blk, devices)
    outs, lses = [], []
    for q, (m, l, acc) in zip(qs, state):
        outs.append((acc / torch.clamp_min(l, 1e-30)).to(q.dtype))
        m0, l0 = m[..., 0], l[..., 0]
        lses.append(torch.where(
            torch.isfinite(m0), m0 + torch.log(torch.clamp_min(l0, 1e-30)), _NEG
        ))
    return outs, lses


def _ring_forward(q, k, v, devices, causal: bool, use_flash: bool):
    """(out, lse) of the ring over ``devices``, both on q's device."""
    outs, lses = _ring_fwd_state(
        _shards(q, devices), _shards(k, devices), _shards(v, devices), devices,
        causal=causal, use_flash=use_flash,
    )
    return (torch.cat([o.to(q.device) for o in outs], dim=2),
            torch.cat([x.to(q.device) for x in lses], dim=2))


def _ring_backward(q, k, v, out, lse, g, devices, causal: bool):
    """The JAX package's ring backward. Each position keeps its q, out, g
    and lse shards; every K/V shard travels the ring once more with its
    f32 dk/dv accumulators. Per hop a position recomputes that rectangle's
    probabilities from (q, k, lse) with :func:`_grads_rect`, adds dq
    locally and dk/dv into the travelling accumulators; a causal hop whose
    block comes from a later position has no live key and is skipped. One
    last rotation brings every accumulator home. Returns (dq, dk, dv) in
    the inputs' dtypes, on q's device."""
    n = len(devices)
    qs, ks, vs, outs, gs = (_shards(x, devices) for x in (q, k, v, out, g))
    lses = [c.to(dev).contiguous() for c, dev in zip(lse.chunk(n, dim=2), devices)]
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
        for j in range(n):
            owner = (j - step) % n
            if causal and owner > j:
                continue
            k_off = owner * s_local
            kp = torch.nn.functional.pad(k_blk[j].to(f32), (0, 0, 0, pad))
            vp = torch.nn.functional.pad(v_blk[j].to(f32), (0, 0, 0, pad))
            dq_c, dk_c, dv_c = _grads_rect(
                qf[j], kp, vp, gf[j], delta[j], lses[j], j * s_local, k_off + s_local,
                causal, blk, k_off=k_off,
            )
            dq[j] += dq_c
            dk_blk[j] += dk_c[:, :, :s_local]
            dv_blk[j] += dv_c[:, :, :s_local]
        if step + 1 < n:
            k_blk, v_blk = _ring_hop(k_blk, devices), _ring_hop(v_blk, devices)
            dk_blk, dv_blk = _ring_hop(dk_blk, devices), _ring_hop(dv_blk, devices)
    # after n − 1 rotations shard s (with its gradients) sits on position
    # s − 1; one more brings every accumulator home
    dk_blk, dv_blk = _ring_hop(dk_blk, devices), _ring_hop(dv_blk, devices)
    return tuple(
        torch.cat([x.to(ref.device) for x in parts], dim=2).to(ref.dtype)
        for parts, ref in ((dq, q), (dk_blk, k), (dv_blk, v))
    )


class _RingTrainable(torch.autograd.Function):
    """The ring forward, keeping (q, k, v, out, lse) for the ring
    backward (:func:`_ring_backward`): memory O(S·d), never an (S, S)
    tensor."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal, use_flash):
        out, lse = _ring_forward(q, k, v, devices, causal, use_flash)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.devices, ctx.causal = devices, causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_backward(q, k, v, out, lse, g, ctx.devices, ctx.causal)
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
    devices = mesh.axis_devices(seq_axis)
    if use_flash is None:
        use_flash = _flash_default(devices)
    _check_seq_divisible(q, mesh, seq_axis)
    if trainable:
        return _RingTrainable.apply(q, k, v, devices, causal, use_flash)
    return _ring_forward(q, k, v, devices, causal, use_flash)[0]


def _ulysses_shard(qs, ks, vs, devices, *, causal: bool, use_flash: bool,
                   trainable: bool = False) -> list:
    """All-to-all sequence↔head resharding (DeepSpeed-Ulysses style).

    In: shard j (B, H, S/n, D) on devices[j] → seq_to_heads → (B, H/n, S,
    D): heads j·H/n.. over the full sequence → local attention (K2 with
    ``use_flash``, dense otherwise) → heads_to_seq back to (B, H, S/n, D)."""
    n = len(devices)

    def seq_to_heads(xs):
        # the tiled all_to_all(split_axis=1, concat_axis=2): position j
        # gathers head chunk j of every position, in position order
        return [
            torch.cat([x.chunk(n, dim=1)[j].to(dev) for x in xs], dim=2).contiguous()
            for j, dev in enumerate(devices)
        ]

    def heads_to_seq(xs):
        # all_to_all(split_axis=2, concat_axis=1): position j gathers
        # sequence chunk j of every position's heads
        return [
            torch.cat([x.chunk(n, dim=2)[j].to(dev) for x in xs], dim=1)
            for j, dev in enumerate(devices)
        ]

    qh, kh, vh = seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs)
    outs = []
    for q, k, v in zip(qh, kh, vh):
        if use_flash and trainable:
            outs.append(flash_attention_trainable(q, k, v, causal))
        elif use_flash:
            outs.append(flash_attention(q, k, v, causal=causal))
        else:
            outs.append(dense_attention(q, k, v, causal=causal))
    return heads_to_seq(outs)


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
    devices = mesh.axis_devices(seq_axis)
    if use_flash is None:
        use_flash = _flash_default(devices)
    n = mesh.shape[seq_axis]
    if q.shape[1] % n:
        raise ValueError(f"heads ({q.shape[1]}) not divisible by axis ({n})")
    _check_seq_divisible(q, mesh, seq_axis)
    outs = _ulysses_shard(
        _shards(q, devices), _shards(k, devices), _shards(v, devices), devices,
        causal=causal, use_flash=use_flash, trainable=trainable,
    )
    return torch.cat([o.to(q.device) for o in outs], dim=2)
