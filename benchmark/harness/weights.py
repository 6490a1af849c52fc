"""A transformer LM's weights from the seed, made on the card by one
``torch.Generator`` in one draw, in float32: the raw input that the
benchmark hands to the program and to the reference alike.

The recipe is the port's (``TransformerLM.create``): the token and
position tables N(0, 0.02); wq, wk, wv, wo and w1 N(0, d**-0.5); w2
N(0, ff**-0.5). Each leaf is a view of the one buffer.
"""

from __future__ import annotations

import torch

from benchmark.harness.traffic import device_generator
from benchmark.work.lm import dims

BLOCK_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w2")


def shapes(config: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, std) of every leaf, in the draw's order."""
    layers, d, _, v, ff = dims(config)
    out = [("embed", (v, d), 0.02), ("pos_embed", (config["n_positions"], d), 0.02)]
    for i in range(layers):
        out += [
            (f"{i}.wq", (d, d), d**-0.5), (f"{i}.wk", (d, d), d**-0.5),
            (f"{i}.wv", (d, d), d**-0.5), (f"{i}.wo", (d, d), d**-0.5),
            (f"{i}.w1", (d, ff), d**-0.5), (f"{i}.w2", (ff, d), ff**-0.5),
        ]
    return out


def lm_leaves(seed: int, config: dict, device) -> dict:
    """{name: float32 tensor} for every leaf of ``shapes(config)``."""
    spec = shapes(config)
    total = sum(_numel(s) for _, s, _ in spec)
    g = device_generator(seed, 7, device)
    buf = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, std in spec:
        n = _numel(shape)
        out[name] = buf[at : at + n].view(shape).mul_(std)
        at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def build_model(leaves: dict, config: dict, compute_dtype: str):
    """The port's ``TransformerLM`` over ``leaves`` (shared, not copied)."""
    from keystone_tpu_torch.models.lm import LMBlock, TransformerLM

    layers = config["n_layer"]
    blocks = [LMBlock(*(leaves[f"{i}.{w}"] for w in BLOCK_LEAVES)) for i in range(layers)]
    return TransformerLM(
        leaves["embed"], leaves["pos_embed"], blocks, num_heads=config["n_head"],
        compute_dtype=compute_dtype, pos_encoding="learned",
    )
