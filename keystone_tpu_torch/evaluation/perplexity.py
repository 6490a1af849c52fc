"""Held-out LM evaluation: cross-entropy, perplexity, bits per token —
port of ``keystone_tpu/evaluation/perplexity.py``.

Non-overlapping (S+1)-token windows slide over a held-out stream; the
model's next-token CE runs batch by batch under ``torch.inference_mode``
and the standard aggregates are reported (for byte-level corpora,
bits_per_token is bits-per-byte). A tensor-parallel model scores through
its vocab-sharded CE; a ring or Ulysses model over a mesh across processes
scores every window on every rank, the attention split over the ranks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from keystone_tpu_torch.models.lm.losses import model_cross_entropy


def _ce(model, toks, logit_chunk: int = 0) -> torch.Tensor:
    """Pure cross-entropy: without the MoE load-balance aux, which is a
    training regularizer, not model quality."""
    return model_cross_entropy(model, toks, logit_chunk)[0]


def evaluate_perplexity(
    model,
    tokens: np.ndarray,
    *,
    seq: int,
    batch: int = 8,
    logit_chunk: int = 0,
) -> dict:
    """Mean next-token cross-entropy of ``model`` over ``tokens``.

    Non-overlapping windows of S+1 tokens (each token predicted once,
    except window-leading tokens, which are conditioned on nothing from
    the previous window); a ragged tail shorter than S+1 is dropped.
    Returns {loss, perplexity, bits_per_token, tokens_scored}.
    ``logit_chunk`` evaluates the CE in S-chunks — the same numbers up to
    summation order."""
    window = seq + 1
    n_win = len(tokens) // window
    if n_win == 0:
        raise ValueError(
            f"held-out stream of {len(tokens)} tokens is shorter than one "
            f"window ({window})"
        )
    wins = np.asarray(tokens[: n_win * window], np.int32).reshape(n_win, window)

    total, count = 0.0, 0
    with torch.inference_mode():
        for i in range(0, n_win, batch):
            chunk = torch.from_numpy(wins[i : i + batch]).to(model.device)
            # the CE averages over the chunk's predicted tokens; re-weight
            # by token count so an uneven tail chunk does not skew it
            n_tok = chunk.shape[0] * seq
            total += float(_ce(model, chunk, logit_chunk)) * n_tok
            count += n_tok
    loss = total / count
    return {
        "loss": loss,
        "perplexity": math.exp(loss),
        "bits_per_token": loss / math.log(2.0),
        "tokens_scored": count,
    }
