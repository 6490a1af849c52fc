"""Plain reference of the decoder-only transformer LM that the GPT-2
configuration runs, with PyTorch operations only (no kernel, no cache,
no batching, nothing of the program), in float32 with TF32 off.

GPT-2's block as the configuration states it: token embedding × √d plus
learned positions; per block, pre-LayerNorm (no gain or shift, eps from
the configuration, population variance), causal multi-head attention
with scores scaled by 1/√head_dim, its output projection and a residual
add, then pre-LayerNorm, ``gelu_new`` (the tanh GELU) between the two
feed-forward products and a residual add; a final LayerNorm and logits
against the tied token embedding.

Served weights are quantized again here, from the raw weights, as the
configuration states (``serve_weights``: symmetric per-output-channel
codes, amax / qmax scales, round half to even; the token table per
row), and computed dequantized. ``bits`` = 4 gives the control.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F32 = torch.float32


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for the span."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def dequantized(w: torch.Tensor, bits: int, channel_axis: int) -> torch.Tensor:
    """``w`` rounded to symmetric ``bits``-bit codes per channel along
    ``channel_axis`` and scaled back, in float32."""
    qmax = 2 ** (bits - 1) - 1
    w = w.to(F32)
    reduce = tuple(a for a in range(w.ndim) if a != channel_axis % w.ndim)
    scale = torch.clamp_min(w.abs().amax(dim=reduce, keepdim=True), 1e-12) / qmax
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def served_leaves(leaves: dict, config: dict, bits: int | None) -> dict:
    """The weights as served: block matrices per output channel and the
    token table per row at ``bits`` bits (None: as they are)."""
    if bits is None:
        return {k: v.to(F32) for k, v in leaves.items()}
    out = {}
    for name, w in leaves.items():
        if name == "pos_embed":
            out[name] = w.to(F32)
        elif name == "embed":
            out[name] = dequantized(w, bits, 0)
        else:
            out[name] = dequantized(w, bits, -1)
    return out


def layer_norm(x, eps: float):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def hidden(w: dict, config: dict, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens → (B, S, d) final hidden states before the last
    LayerNorm."""
    d, h, eps = config["n_embd"], config["n_head"], config["layer_norm_epsilon"]
    hd = d // h
    b, s = tokens.shape
    x = w["embed"][tokens] * math.sqrt(d) + w["pos_embed"][:s]
    causal = torch.ones((s, s), dtype=torch.bool, device=tokens.device).tril()
    for i in range(config["n_layer"]):
        y = layer_norm(x, eps)
        q, k, v = (
            (y @ w[f"{i}.{n}"]).view(b, s, h, hd).transpose(1, 2) for n in ("wq", "wk", "wv")
        )
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        att = torch.softmax(scores, dim=-1) @ v
        x = x + att.transpose(1, 2).reshape(b, s, d) @ w[f"{i}.wo"]
        y = layer_norm(x, eps)
        x = x + F.gelu(y @ w[f"{i}.w1"], approximate="tanh") @ w[f"{i}.w2"]
    return x


def logits(w: dict, config: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, config["layer_norm_epsilon"]) @ w["embed"].T


def served_gaps(w: dict, config: dict, prompt, served, control: dict | None = None):
    """For one request, the gap by which each served token's logit lies
    below the reference's best at its position: (gaps,). With
    ``control`` (weights of the lower precision) the gaps are those of the
    control's first choice at each position instead."""
    dev = w["embed"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev).long()[None]
    first = len(prompt) - 1
    with torch.no_grad(), exact_f32():
        ref = logits(w, config, hidden(w, config, seq))[0, first:]
        if control is None:
            picked = torch.as_tensor(served, device=dev).long()
        else:
            picked = logits(control, config, hidden(control, config, seq))[0, first:].argmax(-1)
        return ref.max(dim=-1).values - ref.gather(1, picked[:, None])[:, 0]
