"""Work that a decoder-only transformer LM needs, counted from its shapes
and the configuration: the matmul parameters, attention over the
positions each token attends, the tied logits, and the kernels' calls.

``P`` below is the block matrices' parameter count, ``L`` the layers,
``d`` the width, ``V`` the vocabulary. Attention over ``c`` cached
positions costs ``4 d c`` flops a layer for one query (scores and the
weighted sum); a causal prompt of ``S`` tokens ``2 d S (S + 1)``.
"""

from __future__ import annotations


def dims(config: dict) -> tuple[int, int, int, int, int]:
    """(layers, width, heads, vocab, ffn width)."""
    d = config["n_embd"]
    ff = config.get("n_inner") or config.get("ff_mult", 4) * d
    return config["n_layer"], d, config["n_head"], config["vocab_size"], ff


def block_params(config: dict) -> int:
    layers, d, _, _, ff = dims(config)
    return layers * (4 * d * d + 2 * d * ff)


def params(config: dict) -> int:
    """Every weight: the blocks, the token and position tables."""
    _, d, _, v, _ = dims(config)
    return block_params(config) + v * d + config["n_positions"] * d


def block_matmuls(config: dict) -> list[tuple[int, int]]:
    """(in, out) of each block's weight products, in the block's order."""
    _, d, _, _, ff = dims(config)
    return [(d, d), (d, d), (d, d), (d, d), (d, ff), (ff, d)]


def prefill_flops(config: dict, s: int) -> float:
    """One prompt of ``s`` tokens: the blocks over every position,
    causal attention, and the logits of the last position only."""
    layers, d, _, v, _ = dims(config)
    return 2.0 * block_params(config) * s + layers * 2.0 * d * s * (s + 1) + 2.0 * v * d


def decode_flops(config: dict, attended: int) -> float:
    """One generated token that attends ``attended`` positions (itself
    included)."""
    layers, d, _, v, _ = dims(config)
    return 2.0 * block_params(config) + layers * 4.0 * d * attended + 2.0 * v * d


def train_step_flops(config: dict, batch: int, seq: int) -> float:
    """One train step, as the port's ``models/lm/model.train_step_flops``
    counts it for a dense model: ``6 P tokens`` for the matmul work (P every
    stored value) plus the attention score and value terms
    ``12 L d S² B``, forward and backward."""
    layers, d, _, _, _ = dims(config)
    return 6.0 * params(config) * batch * seq + 12.0 * layers * d * seq * seq * batch


def attention_call(config: dict, batch: int, s: int, bytes_per: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one causal attention call over ``s``
    positions (K2's forward): q, k and v read once and the output written
    once."""
    _, d, h, _, _ = dims(config)
    hd = d // h
    ops = batch * h * 2.0 * hd * s * (s + 1)
    nbytes = 4.0 * batch * h * s * hd * bytes_per
    return ops, nbytes


def int8_matmul_call(m: int, k: int, n: int, act_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one weight-only int8 product (K4): an
    (m, k) activation by (k, n) int8 codes with n f32 scales, the (m, n)
    output written once."""
    ops = 2.0 * m * k * n
    nbytes = k * n + 4.0 * n + act_bytes * (m * k + m * n)
    return ops, nbytes
