"""Dense attention — port of ``dense_attention`` in
``keystone_tpu/ops/attention.py``.

The single-device reference attention, and the CPU path of the LM's
``auto`` local attention. Ring and Ulysses attention (sequence parallel
over several devices) come with the multi-device slice.
"""

from __future__ import annotations

import math

import torch


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
