"""Next-token losses for the transformer LM — port of
``keystone_tpu/models/lm/losses.py``, forward only.

The numerically sensitive ``logsumexp − gold`` form lives once here
(:func:`token_cross_entropy`); the chunked variant reduces the CE in
S-chunks so the (B, S, V) f32 logits never exist at once. Under no-grad
the chunk loop holds one chunk's logits at a time; the recompute that the
JAX package's ``jax.checkpoint`` does for the backward comes with the
training slice.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.models.lm.model import TransformerLM, _tied_logits

# the JAX package's default ``moe_aux_weight``; no layer of the port routes
# experts yet, so the aux it weighs is 0
MOE_AUX_WEIGHT = 0.01


def token_cross_entropy(logits, targets) -> torch.Tensor:
    """Mean next-token cross-entropy. logits: (B, S, V) f32; targets:
    (B, S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def chunked_token_cross_entropy(x, embed, targets, cdt, chunk: int) -> torch.Tensor:
    """Mean next-token CE from final hidden states x (B, S, d) without the
    whole (B, S, V) logits: each S-chunk's logits are built, reduced to
    its CE sum and dropped."""
    b, s, _ = x.shape
    if chunk <= 0 or s % chunk:
        raise ValueError(
            f"logit_chunk={chunk} must be a positive divisor of the "
            f"sequence length {s}"
        )
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        tt = targets[:, start : start + chunk]
        logits = _tied_logits(x[:, start : start + chunk], embed, cdt)  # (B, chunk, V) f32
        # mean × count turns the shared CE form back into this chunk's sum
        total = total + token_cross_entropy(logits, tt) * tt.numel()
    return total / (b * s)


def next_token_loss(model: TransformerLM, tokens, logit_chunk: int = 0) -> torch.Tensor:
    """Mean cross-entropy of predicting ``tokens[:, 1:]`` from the prefix
    (the model runs on the first S tokens of an S+1 window), plus the
    weighted MoE load-balance auxiliary (0 without experts).
    ``logit_chunk > 0`` computes the CE in S-chunks."""
    tokens = torch.as_tensor(tokens, device=model.device)
    if logit_chunk:
        x, aux = model.backbone(tokens[:, :-1])
        ce = chunked_token_cross_entropy(x, model.embed, tokens[:, 1:], model.cdt, logit_chunk)
    else:
        logits, aux = model.forward_with_aux(tokens[:, :-1])
        ce = token_cross_entropy(logits, tokens[:, 1:])
    return ce + MOE_AUX_WEIGHT * aux
