"""Next-token losses for the transformer LM — port of
``keystone_tpu/models/lm/losses.py``.

The numerically sensitive ``logsumexp − gold`` form lives once here
(:func:`token_cross_entropy`); the chunked variant reduces the CE in
S-chunks so the (B, S, V) f32 logits never exist at once. Under autograd
each chunk runs under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``), so the backward, too, holds one chunk's logits at a
time.
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


def chunked_token_cross_entropy(x, embed, targets, cdt, chunk: int) -> torch.Tensor:
    """Mean next-token CE from final hidden states x (B, S, d) without the
    whole (B, S, V) logits: each S-chunk's logits are built, reduced to
    its CE sum and dropped — and, under autograd, recomputed in the
    backward."""
    b, s, _ = x.shape
    if chunk <= 0 or s % chunk:
        raise ValueError(
            f"logit_chunk={chunk} must be a positive divisor of the "
            f"sequence length {s}"
        )

    def chunk_sum(xx, tt):
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


def next_token_loss(model: TransformerLM, tokens, logit_chunk: int = 0) -> torch.Tensor:
    """Mean cross-entropy of predicting ``tokens[:, 1:]`` from the prefix
    (the model runs on the first S tokens of an S+1 window), plus the
    MoE load-balance auxiliary weighted by ``model.moe_aux_weight`` (0
    without experts).
    ``logit_chunk > 0`` computes the CE in S-chunks."""
    tokens = torch.as_tensor(tokens, device=model.device)
    if logit_chunk:
        x, aux = model.backbone(tokens[:, :-1])
        ce = chunked_token_cross_entropy(x, model.embed, tokens[:, 1:], model.cdt, logit_chunk)
    else:
        logits, aux = model.forward_with_aux(tokens[:, :-1])
        ce = token_cross_entropy(logits, tokens[:, 1:])
    return ce + model.moe_aux_weight * aux
