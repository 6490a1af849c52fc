"""Fused flash-attention forward — port of
``keystone_tpu/ops/flash_attention.py``.

:func:`flash_attention` is kernel K2's wrapper (``csrc/flash_attention.cu``):
q (B, H, S_q, D) against k, v (B, H, S_k, D), the online softmax in f32,
causal masking begin-aligned at ``q_offset``/``k_offset``, masked scores at
−1e30 with their p set to 0 (a fully masked row outputs 0), and optionally
the row logsumexp. A CUDA tensor launches the kernel (or raises); a CPU
tensor takes :func:`flash_attention_plain`, a blockwise online softmax with
the kernel's rounding points.

:func:`flash_attention_step` is kernel K3's wrapper
(``csrc/flash_attention_step.cu``): one online-softmax update of the
carried (m, l, acc) state by a single K/V block at global offsets, the hop
of ring attention. All of its arithmetic is f32 on widened inputs; a CPU
tensor takes :func:`flash_attention_step_plain`.

:func:`flash_attention_trainable` is the differentiable wrapper: K2 forward
and, as in the JAX package, a backward in plain tensor ops — the dense
recompute at short context, the blockwise FlashAttention backward
(:func:`_blockwise_grads`, from q, k, v, out and K2's lse) above
``KST_FLASH_DENSE_BWD_MAX`` bytes of transients. The JAX package's
backward is jnp outside any Pallas kernel, so it has no kernel here
either.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
from torch.autograd.function import once_differentiable

from keystone_tpu_torch.core.kernels import (
    Kernel,
    attention_ops,
    check_launch,
    counting,
    launch_on,
    note_ops,
    uncounted,
)

FLASH_ATTENTION = Kernel("flash_attention", "flash_attention.cu")
FLASH_ATTENTION_STEP = Kernel("flash_attention_step", "flash_attention_step.cu")

_NEG = -1e30  # masked-score value: exp(_NEG - m) underflows to exactly 0
_BLOCK_K = 64  # keys per tile, the kernel's
_MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _tma_ready(x, d_in: int):
    """``x`` as the Hopper kernels' TMA loads take it: rows of ``d_in``
    elements (zero columns past D: exact, they add 0 to every product) and
    a 16-byte-aligned base."""
    if x.shape[-1] != d_in:
        x = torch.nn.functional.pad(x, (0, d_in - x.shape[-1]))
    return x if x.data_ptr() % 16 == 0 else x.clone()


_SCHED: dict = {}


def _sched(device, stream: int) -> int:
    """The two int32 (zero between launches) that the bf16 kernels'
    persistent blocks take their work items from; each launch's last block
    resets them. One pair per device and stream, so launches that may run
    at once never share one. Under CUDA-graph capture a pair is made for
    the graph and not kept."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    buf = _SCHED.get(key)
    if buf is None:
        buf = torch.zeros(2, dtype=torch.int32, device=device)
        if not torch.cuda.is_current_stream_capturing():
            _SCHED[key] = buf
    return buf.data_ptr()


def _row_width(x) -> int:
    """The row width the kernel reads: D for f32 (CUDA cores), D rounded up
    to a multiple of 8 for bf16 (TMA needs 16-byte rows)."""
    d = x.shape[-1]
    return d if x.dtype == torch.float32 else -(-d // 8) * 8


def _scale(d: int, dtype: torch.dtype) -> float:
    """1/√D rounded to ``dtype``, as the TPU kernel casts it."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


def flash_attention_plain(
    q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0,
    return_lse: bool = False, out_dtype: torch.dtype | None = None,
):
    """K2's plain version, on inputs already in the kernel's dtype: q·scale
    rounded to q's dtype, f32 scores, a 64-key online softmax whose p is
    rounded to v's dtype before the PV product, ``acc / max(l, 1e-30)``
    rounded once to ``out_dtype`` (default q's dtype), lse = ``m +
    log(max(l, 1e-30))``."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    # a Python scalar holding the rounded scale: q's dtype times it rounds
    # once, as the kernel does
    qs = (q * _scale(d, q.dtype)).to(torch.float32)
    q_pos = q_offset + torch.arange(s_q, device=q.device)[:, None]
    m = torch.full((b, h, s_q, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_q, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=q.device)
    for start in range(0, s_k, _BLOCK_K):
        k_blk = k[:, :, start : start + _BLOCK_K]
        v_blk = v[:, :, start : start + _BLOCK_K]
        s = qs @ k_blk.to(torch.float32).transpose(-1, -2)
        k_pos = k_offset + start + torch.arange(k_blk.shape[2], device=q.device)
        # the blocks end at S_k, so only causality masks a key here
        valid = q_pos >= k_pos[None, :] if causal else torch.ones_like(k_pos, dtype=torch.bool)
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = p.to(v.dtype).to(torch.float32) @ v_blk.to(torch.float32)
        acc = acc * alpha + pv
        m = m_new
    den = torch.clamp_min(l, 1e-30)
    out = (acc / den).to(out_dtype or q.dtype)
    if return_lse:
        return out, (m + torch.log(den))[..., 0]
    return out


def _launch(q, k, v, *, causal, q_offset, k_offset, out_dtype, return_lse):
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if k.shape != (b, h, s_k, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    if not 0 < d <= _MAX_D:
        raise ValueError(f"flash_attention: head dim {d} outside 1..{_MAX_D}")
    # the f32 kernel writes f32; an f32 result cast once to bf16 is the
    # same single rounding the kernel would do
    kernel_out = torch.float32 if q.dtype == torch.float32 else out_dtype
    out = torch.empty((b, h, s_q, d), dtype=kernel_out, device=q.device)
    lse = (
        torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
        if return_lse
        else None
    )
    if b * h and s_q:
        fn = FLASH_ATTENTION.function(
            "keystone_flash_attention",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2,
        )
        d_in = _row_width(q)
        if q.dtype == torch.bfloat16:
            q, k, v = (_tma_ready(x, d_in) for x in (q, k, v))
        code = launch_on(q.device, lambda s: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b * h, s_q, s_k, d, d_in, int(q_offset), int(k_offset), int(causal),
            _scale(d, q.dtype), _DTYPES[q.dtype], _DTYPES[kernel_out],
            _sched(q.device, s), s,
        ))
        check_launch(FLASH_ATTENTION, code)
        FLASH_ATTENTION.launches += 1
    out = out.to(out_dtype)
    return (out, lse) if return_lse else out


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    block_q: int | None = None,
    block_k: int | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
    mxu_dtype=None,
    kv_resident: bool | None = None,
    return_lse: bool = False,
):
    """Fused attention. q: (B, H, S_q, D); k, v: (B, H, S_k, D), f32 or
    bf16, D ≤ 128. Returns q's dtype, and with ``return_lse`` also the row
    logsumexp (B, H, S_q) f32.

    ``mxu_dtype`` casts q, k, v before the products (the output keeps q's
    dtype). ``block_q``, ``block_k`` and ``kv_resident`` sized the TPU
    kernel's VMEM blocks; the Hopper kernel picks its own tiles, so they
    are accepted and ignored."""
    del block_q, block_k, kv_resident
    out_dtype = q.dtype
    if mxu_dtype is not None:
        q, k, v = (x.to(mxu_dtype) for x in (q, k, v))
    if counting():
        b, h, s_q, d = q.shape
        note_ops(attention_ops(b, h, s_q, k.shape[2], d, causal=causal,
                               q_offset=q_offset, k_offset=k_offset))
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_plain(
                q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
                return_lse=return_lse, out_dtype=out_dtype,
            )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(
        q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
        out_dtype=out_dtype, return_lse=return_lse,
    )


def _live_key_tiles(s_q: int, s_k: int, q_offset: int, k_offset: int, causal: bool) -> int:
    """The 64-key tiles any query row can see: causal tiles wholly past
    the last query position are skipped, which is exact (a fully masked
    tile leaves the state unchanged)."""
    n_k = -(-s_k // _BLOCK_K)
    if not causal:
        return n_k
    span = q_offset + s_q - k_offset
    return min(n_k, max(0, -(-span // _BLOCK_K)))


def flash_attention_step_plain(q, k_blk, v_blk, m, l, acc, *, q_offset, k_offset, causal=False):
    """K3's plain version: q, k and v widened to f32, q·(1/√D) in f32, and
    for each 64-key tile ``s = where(valid, s, −1e30)``, ``m_new = max(m,
    rowmax s)``, ``p = where(valid, exp(s − m_new), 0)``, ``alpha = exp(m −
    m_new)``, ``l = l·alpha + Σp``, ``acc = acc·alpha + p·v``. Returns new
    (m, l, acc) tensors, f32."""
    d, s_q, s_k = q.shape[3], q.shape[2], k_blk.shape[2]
    f32 = torch.float32
    qs = q.to(f32) * (1.0 / math.sqrt(d))
    q_pos = q_offset + torch.arange(s_q, device=q.device)[:, None]
    m = m.to(f32, copy=True)[..., None]
    l = l.to(f32, copy=True)[..., None]
    acc = acc.to(f32, copy=True)
    for t in range(_live_key_tiles(s_q, s_k, q_offset, k_offset, causal)):
        start = t * _BLOCK_K
        k_t = k_blk[:, :, start : start + _BLOCK_K].to(f32)
        v_t = v_blk[:, :, start : start + _BLOCK_K].to(f32)
        s = qs @ k_t.transpose(-1, -2)
        # the tiles end at S_k, so only causality masks a key here
        if causal:
            k_pos = k_offset + start + torch.arange(k_t.shape[2], device=q.device)
            valid = q_pos >= k_pos[None, :]
            s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(valid, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v_t
        m = m_new
    return m[..., 0], l[..., 0], acc


def _launch_step(q, k_blk, v_blk, m, l, acc, *, q_offset, k_offset, causal):
    b, h, s_q, d = q.shape
    s_k = k_blk.shape[2]
    if (
        k_blk.shape != (b, h, s_k, d) or v_blk.shape != k_blk.shape
        or m.shape != (b, h, s_q) or l.shape != m.shape or acc.shape != q.shape
    ):
        raise ValueError(
            f"flash_attention_step: q {tuple(q.shape)}, k {tuple(k_blk.shape)}, "
            f"v {tuple(v_blk.shape)}, m {tuple(m.shape)}, l {tuple(l.shape)}, "
            f"acc {tuple(acc.shape)} do not match"
        )
    if q.dtype not in _DTYPES or k_blk.dtype != q.dtype or v_blk.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_step takes float32 or bfloat16 q, k, v of one "
            f"dtype; got {q.dtype}, {k_blk.dtype}, {v_blk.dtype}"
        )
    if any(x.dtype != torch.float32 for x in (m, l, acc)):
        raise TypeError("flash_attention_step: the state m, l, acc must be float32")
    tensors = (q, k_blk, v_blk, m, l, acc)
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention_step: all inputs must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention_step takes contiguous tensors")
    if not 0 < d <= _MAX_D:
        raise ValueError(f"flash_attention_step: head dim {d} outside 1..{_MAX_D}")
    if not all(-(2**31) <= o < 2**31 for o in (q_offset, k_offset)):
        raise ValueError("flash_attention_step: offsets must fit in int32")
    m_out, l_out, acc_out = torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc)
    if b * h and s_q:
        fn = FLASH_ATTENTION_STEP.function(
            "keystone_flash_attention_step",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_int] + [ctypes.c_void_p] * 2,
        )
        d_in = _row_width(q)
        if q.dtype == torch.bfloat16:
            q, k_blk, v_blk = (_tma_ready(x, d_in) for x in (q, k_blk, v_blk))
        code = launch_on(q.device, lambda s: fn(
            q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
            acc_out.data_ptr(), b * h, s_q, s_k, d, d_in, int(q_offset),
            int(k_offset), int(causal), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
            _sched(q.device, s), s,
        ))
        check_launch(FLASH_ATTENTION_STEP, code)
        FLASH_ATTENTION_STEP.launches += 1
    return m_out, l_out, acc_out


def flash_attention_step(
    q,
    k_blk,
    v_blk,
    m,
    l,
    acc,
    *,
    q_offset: int,
    k_offset: int,
    causal: bool = False,
    block_q: int | None = None,
    block_k: int | None = None,
):
    """One online-softmax update: attend q over a single K/V block.

    q: (B, H, S_q, D); k_blk, v_blk: (B, H, S_k, D), f32 or bf16 on the
    card (any float dtype on the CPU), D ≤ 128. State: m, l (B, H, S_q) and
    acc (B, H, S_q, D), f32 (start m at −1e30, l and acc at 0). The offsets
    are the global positions of the q and k windows. Returns new (m, l,
    acc); finalize with ``acc / max(l, 1e-30)``.

    ``block_q`` and ``block_k`` sized the TPU kernel's VMEM blocks; the
    Hopper kernel picks its own tiles, so they are accepted and ignored.
    The TPU layout option ``padded_state`` (m, l in 128 lanes) has no
    counterpart."""
    del block_q, block_k
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=causal)
    if counting():
        b, h, s_q, d = q.shape
        note_ops(attention_ops(b, h, s_q, k_blk.shape[2], d, **kw))
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_step_plain(q, k_blk, v_blk, m, l, acc, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_step: unsupported device {q.device}")
    return _launch_step(q, k_blk, v_blk, m, l, acc, **kw)


def _env_int(name: str, default: int) -> int:
    """A tuning knob from the environment, read at call time; unset or
    malformed keeps ``default``."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# bytes budget for the dense-recompute backward's transient (S_q, S_k)
# tensors (about 4 of them, f32, per (b, h)): above it the blockwise
# backward takes over
_DENSE_BWD_MAX_BYTES = 4 << 30


def _dense_bwd_max_bytes() -> int:
    # KST_FLASH_DENSE_BWD_MAX=0 forces the blockwise backward everywhere
    return _env_int("KST_FLASH_DENSE_BWD_MAX", _DENSE_BWD_MAX_BYTES)


def _bwd_block() -> int:
    """Keys per block of the blockwise backward (``KST_FLASH_BWD_BLOCK``)."""
    return _env_int("KST_FLASH_BWD_BLOCK", 512)


def _dense_bwd_bytes(q, k) -> int:
    b, h, s_q, _ = q.shape
    return 4 * 4 * b * h * s_q * k.shape[2]


def _bwd_mask(q_pos, k_pos, s_k_valid, causal: bool):
    """(S_q, blk) validity mask of one K/V block: padding and causality.
    Causal positions are begin-aligned (q_pos = i, k_pos = j), the flash
    forward's convention; the trainable wrapper rejects causal S_q ≠ S_k,
    where begin- and end-aligned masks differ."""
    valid = (k_pos < s_k_valid)[None, :]
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    return valid


def _bwd_causal_chunks() -> int:
    """Causal q chunks of the blockwise backward (``KST_FLASH_BWD_CHUNKS``):
    each chunk sweeps only its live K prefix, (n+1)/2n of the rectangle."""
    return _env_int("KST_FLASH_BWD_CHUNKS", 8)


def _grads_rect(qf, kp, vp, gf, delta, lse, q_off, s_k_valid, causal, block, k_off=0):
    """The blockwise backward over one q range: a loop over the (padded)
    K/V blocks, each score block recomputed from (q, k, lse). Positions
    are global and begin-aligned (``q_off``/``k_off`` are the positions of
    the first q and k rows; a nonzero ``k_off`` serves the ring backward's
    rotating shards). Returns f32 (dq, dk, dv), dk and dv over kp's whole
    padded length. A fully masked row (lse −1e30) gets p = 0, so zero
    gradients."""
    b, h, s_q, d = qf.shape
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)
    nb = kp.shape[2] // block
    q_pos = q_off + torch.arange(s_q, device=qf.device)
    dq = torch.zeros((b, h, s_q, d), dtype=f32, device=qf.device)
    dk = torch.empty((b, h, nb * block, d), dtype=f32, device=qf.device)
    dv = torch.empty_like(dk)
    for j in range(nb):
        cols = slice(j * block, (j + 1) * block)
        kf = kp[:, :, cols].to(f32)
        vf = vp[:, :, cols].to(f32)
        k_pos = k_off + j * block + torch.arange(block, device=qf.device)
        mask = _bwd_mask(q_pos, k_pos, s_k_valid, causal)
        # p = where(mask, exp(q·kᵀ·scale − lse), 0), in place
        p = torch.einsum("bhqd,bhkd->bhqk", qf, kf).mul_(scale)
        p = p.sub_(lse[..., None]).exp_().masked_fill_(~mask, 0.0)
        dv[:, :, cols] = torch.einsum("bhqk,bhqd->bhkd", p, gf)
        # ds = p · (dp − delta)
        ds = torch.einsum("bhqd,bhkd->bhqk", gf, vf).sub_(delta[..., None]).mul_(p)
        del p
        dq.add_(torch.einsum("bhqk,bhkd->bhqd", ds, kf).mul_(scale))
        dk[:, :, cols] = torch.einsum("bhqk,bhqd->bhkd", ds, qf).mul_(scale)
    return dq, dk, dv


def _blockwise_grads(q, k, v, g, out, lse, causal: bool, block: int):
    """FlashAttention-style backward from (q, k, v, out, lse). Non-causal:
    one rectangle. Causal: q cut into block-aligned chunks, each sweeping
    only the K blocks at or below its diagonal (about 0.56·S² of score
    work at 8 chunks instead of S²)."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    nb = -(-s_k // block)
    pad = nb * block - s_k
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.to(torch.float32)
    gf = g.to(torch.float32)
    # delta_i = Σ_d g·out, the softmax Jacobian's diagonal term
    delta = torch.sum(gf * out.to(torch.float32), dim=-1)
    if not causal:
        dq, dk, dv = _grads_rect(qf, kp, vp, gf, delta, lse, 0, s_k, False, block)
        return dq.to(q.dtype), dk[:, :, :s_k].to(k.dtype), dv[:, :, :s_k].to(v.dtype)

    # causal (S_q = S_k, enforced by the wrapper): chunk edges in whole K
    # blocks, so each chunk's live prefix is block-aligned
    n_chunks = min(_bwd_causal_chunks(), nb)
    edges = sorted({round(nb * c / n_chunks) for c in range(n_chunks + 1)})
    dq_parts = []
    dk = torch.zeros((b, h, nb * block, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for lo, hi in zip(edges[:-1], edges[1:]):
        q0, q1 = lo * block, min(hi * block, s_q)
        k_end = hi * block  # K blocks [0, hi) are the live prefix
        dq_c, dk_c, dv_c = _grads_rect(
            qf[:, :, q0:q1], kp[:, :, :k_end], vp[:, :, :k_end], gf[:, :, q0:q1],
            delta[:, :, q0:q1], lse[:, :, q0:q1], q0, s_k, True, block,
        )
        dq_parts.append(dq_c)
        dk[:, :, :k_end] += dk_c
        dv[:, :, :k_end] += dv_c
    dq = torch.cat(dq_parts, dim=2)
    return dq.to(q.dtype), dk[:, :, :s_k].to(k.dtype), dv[:, :, :s_k].to(v.dtype)


class _FlashTrainable(torch.autograd.Function):
    """K2 forward; the backward recomputes attention. At short context
    (``_dense_bwd_bytes`` within ``_dense_bwd_max_bytes()``) it keeps only
    (q, k, v) and differentiates dense attention; otherwise it keeps (q,
    k, v, out, lse), K2's lse, and runs :func:`_blockwise_grads`. Nothing
    S²-sized lives from the forward to the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.blockwise = _dense_bwd_bytes(q, k) > _dense_bwd_max_bytes()
        if not any(ctx.needs_input_grad[:3]):  # scoring and serving: no backward
            return flash_attention(q, k, v, causal=causal)
        if not ctx.blockwise:
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v, causal=causal)
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.blockwise:
            q, k, v, out, lse = ctx.saved_tensors
            return (*_blockwise_grads(q, k, v, g, out, lse, ctx.causal, _bwd_block()), None)
        from keystone_tpu_torch.ops.attention import dense_attention

        q, k, v = (x.detach().requires_grad_(True) for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = dense_attention(q, k, v, causal=ctx.causal)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def flash_attention_trainable(q, k, v, causal: bool = False):
    """Differentiable fused attention: K2 forward (its plain version on the
    CPU), recompute backward (:class:`_FlashTrainable`). Causal
    cross-attention (S_q ≠ S_k) is rejected: the flash forward masks
    begin-aligned, dense attention end-aligned, and the two agree only at
    S_q = S_k."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(
            f"flash_attention_trainable: causal cross-attention with "
            f"s_q={q.shape[2]} != s_k={k.shape[2]} is ambiguous"
        )
    return _FlashTrainable.apply(q, k, v, causal)
