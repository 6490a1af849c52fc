"""Next-token losses for the transformer LM — port of
``keystone_tpu/models/lm/losses.py``.

The numerically sensitive ``logsumexp − gold`` form lives once here
(:func:`token_cross_entropy`); the chunked variant reduces the CE in
S-chunks so the (B, S, V) f32 logits never exist at once. Under autograd
each chunk runs under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``), so the backward, too, holds one chunk's logits at a
time.

Under a vocab-sharded tensor-parallel layout the logits stay sharded: the
row max and the two sums of the CE (the exponentials and the gold logit)
are reduced over the model axis (:func:`sharded_cross_entropy_sum`), so no
position holds the (B, S, V) logits whole.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from keystone_tpu_torch.models.lm.model import TransformerLM, _tied_logits


def token_cross_entropy(logits, targets) -> torch.Tensor:
    """Mean next-token cross-entropy. logits: (B, S, V) f32; targets:
    (B, S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def sharded_cross_entropy_sum(parts, targets, tp) -> torch.Tensor:
    """The summed next-token CE over vocab-sharded logits: ``parts`` holds
    each of this process's model-axis positions' (B, S, V/n) f32 block.
    The row max goes over the axis outside autograd (the logsumexp does
    not depend on it), and the sums of the exponentials and of the gold
    logit are added over the axis."""
    comm = tp.comm
    m = comm.pmax([p.amax(dim=-1) for p in parts])
    sums, golds = [], []
    for pos, p in zip(comm.positions, parts):
        v_local = p.shape[-1]
        t = targets.to(p.device).long() - pos * v_local
        live = (t >= 0) & (t < v_local)
        sums.append(torch.exp(p - m.to(p.device)[..., None]).sum(dim=-1))
        gold = torch.gather(p, -1, t.clamp(0, v_local - 1)[..., None])[..., 0]
        golds.append(torch.where(live, gold, torch.zeros((), dtype=gold.dtype,
                                                         device=gold.device)))
    home = m.device
    logz = m + torch.log(comm.psum(sums, device=home))
    return torch.sum(logz - comm.psum(golds, device=home))


def _tp_vocab(tp) -> bool:
    return tp is not None and tp.vocab


def chunked_token_cross_entropy(x, embed, targets, cdt, chunk: int, model=None) -> torch.Tensor:
    """Mean next-token CE from final hidden states x (B, S, d) without the
    whole (B, S, V) logits: each S-chunk's logits are built, reduced to
    its CE sum and dropped — and, under autograd, recomputed in the
    backward. ``model`` (whose ``embed`` is ``embed``) keeps a
    vocab-sharded model's logits sharded."""
    b, s, _ = x.shape
    if chunk <= 0 or s % chunk:
        raise ValueError(
            f"logit_chunk={chunk} must be a positive divisor of the "
            f"sequence length {s}"
        )

    tp = None if model is None else model.tp

    def chunk_sum(xx, tt):
        if _tp_vocab(tp):
            return sharded_cross_entropy_sum(model.logit_parts(xx), tt, tp)
        logits = _tied_logits(xx, embed, cdt)  # (B, chunk, V) f32
        # mean × count turns the shared CE form back into this chunk's sum
        return token_cross_entropy(logits, tt) * tt.numel()

    recompute = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        args = (x[:, start : start + chunk], targets[:, start : start + chunk])
        part = checkpoint(chunk_sum, *args, use_reentrant=False) if recompute else chunk_sum(*args)
        total = total + part
    return total / (b * s)


def model_cross_entropy(model: TransformerLM, tokens, logit_chunk: int = 0) -> tuple:
    """(mean cross-entropy of predicting ``tokens[:, 1:]`` from the prefix,
    the MoE load-balance aux): the model runs on the first S tokens of an
    S+1 window. ``logit_chunk > 0`` computes the CE in S-chunks."""
    tokens = torch.as_tensor(tokens, device=model.device)
    targets = tokens[:, 1:]
    if logit_chunk:
        x, aux = model.backbone(tokens[:, :-1])
        return chunked_token_cross_entropy(x, model.embed, targets, model.cdt, logit_chunk,
                                           model=model), aux
    if _tp_vocab(model.tp):
        x, aux = model.backbone(tokens[:, :-1])
        return sharded_cross_entropy_sum(model.logit_parts(x), targets, model.tp) / targets.numel(), aux
    logits, aux = model.forward_with_aux(tokens[:, :-1])
    return token_cross_entropy(logits, targets), aux


def next_token_loss(model: TransformerLM, tokens, logit_chunk: int = 0) -> torch.Tensor:
    """Mean cross-entropy of predicting ``tokens[:, 1:]`` from the prefix
    (the model runs on the first S tokens of an S+1 window), plus the
    MoE load-balance auxiliary weighted by ``model.moe_aux_weight`` (0
    without experts).
    ``logit_chunk > 0`` computes the CE in S-chunks."""
    ce, aux = model_cross_entropy(model, tokens, logit_chunk)
    return ce + model.moe_aux_weight * aux
