"""Decoder-only transformer LM — the workload's entry point and CLI, port
of ``keystone_tpu/models/lm_transformer.py``:

    python -m keystone_tpu_torch.models.lm_transformer --compute-dtype bfloat16 ...

:func:`run` builds the model on the card (``device="cpu"`` asks for the
CPU), trains it on the synthetic Markov corpus or on ``--corpus`` (byte
tokens, 10 % held out and scored with
:func:`~keystone_tpu_torch.evaluation.perplexity.evaluate_perplexity`),
and returns the JAX package's result keys. The weights are drawn from a
``torch.Generator`` seeded with ``--seed``: the recipe of the JAX
package's, not its bits.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from keystone_tpu_torch.core.config import arg, parse_config
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.models.lm.model import TransformerLM
from keystone_tpu_torch.models.lm.sharding import shard_params
from keystone_tpu_torch.models.lm.train import synthetic_corpus, train

logger = get_logger("keystone_tpu_torch.models.lm_transformer")


@dataclasses.dataclass
class LMConfig:
    steps: int = arg(default=60, help="training steps")
    batch: int = arg(default=8)
    seq: int = arg(default=256)
    dim: int = arg(default=256)
    depth: int = arg(default=4)
    num_heads: int = arg(default=8)
    num_kv_heads: int = arg(
        default=0,
        help="GQA: K/V heads (0 = num_heads/MHA, 1 = MQA); shrinks the "
        "decode cache by num_heads/num_kv_heads",
    )
    vocab: int = arg(default=256)
    lr: float = arg(default=3e-4)
    seq_mode: str = arg(
        default="local", help="attention strategy: local | ring | ulysses"
    )
    compute_dtype: str = arg(
        default="float32",
        help="matmul/activation dtype (params stay float32); bfloat16 feeds "
        "the tensor cores",
    )
    seed: int = arg(default=0)
    moe_every: int = arg(
        default=0,
        help="replace every k-th block's FFN with a top-2 MoE (0 = dense)",
    )
    num_experts: int = arg(default=8)
    pos_encoding: str = arg(
        default="learned", help="position encoding: learned | rope"
    )
    corpus: str = arg(
        default="",
        help="path to a text file/dir (byte-level tokens, vocab forced to "
        "256, 10%% held out for perplexity); default: synthetic Markov",
    )
    schedule: str = arg(
        default="constant", help="lr schedule: constant | cosine (warmup)"
    )
    grad_clip: float = arg(
        default=0.0, help="global-norm gradient clip (0 = off)"
    )
    checkpoint_dir: str = arg(
        default="",
        help="checkpoint/resume directory (preemption-safe training)",
    )
    checkpoint_every: int = arg(
        default=0,
        help="steps between checkpoints (0 = steps//10, ~10 per run)",
    )
    logit_chunk: int = arg(
        default=0,
        help="compute the CE in this many-position chunks so the "
        "(B, S, V) f32 logits never materialize (0 = dense; must divide "
        "seq; the long-context memory lever)",
    )


def run(conf: LMConfig, mesh=None, device=None) -> dict:
    """Build, train and (with ``--corpus``) score the LM on ``device``
    (default: the card). In a process group of several processes (the
    launcher's ``--multihost``), the model lives on this process's card
    and trains data-parallel over the group's mesh; with ``--seq-mode
    ring`` or ``ulysses`` its attention runs sequence-parallel over the
    processes instead, every rank on the whole batch. A ``mesh`` whose
    model axis is wider than 1 shards the weights (``shard_params``),
    as the JAX package's ``run`` does. With no ``mesh`` and
    more than one card visible in one process, the JAX package's default
    mesh over every card is built, and a local model trains its batch on
    the first card (``train`` says so once)."""
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.parallel.mesh import create_mesh

    if conf.schedule not in ("constant", "cosine"):
        # fail before the corpus load and the model's creation
        raise ValueError(f"--schedule {conf.schedule!r}; expected constant|cosine")
    if multihost.process_count() > 1:
        mesh = mesh if mesh is not None else create_mesh()
        device = multihost.local_device()
    device = resolve_device(device)
    if mesh is None and device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = create_mesh()
    valid = None
    if conf.corpus:
        from keystone_tpu_torch.loaders.text import BYTE_VOCAB, load_text_corpus

        corpus, valid = load_text_corpus(conf.corpus)
        conf = dataclasses.replace(conf, vocab=BYTE_VOCAB)
    model = TransformerLM.create(
        vocab=conf.vocab,
        max_seq=conf.seq,
        dim=conf.dim,
        depth=conf.depth,
        num_heads=conf.num_heads,
        seq_mode=conf.seq_mode,
        mesh=mesh if conf.seq_mode != "local" else None,
        compute_dtype=conf.compute_dtype,
        moe_every=conf.moe_every,
        num_experts=conf.num_experts,
        pos_encoding=conf.pos_encoding,
        num_kv_heads=conf.num_kv_heads,
        device=device,
        generator=torch.Generator(device=device).manual_seed(conf.seed),
    )
    model = shard_params(model, mesh)
    if not conf.corpus:
        corpus = synthetic_corpus(200_000, conf.vocab, seed=conf.seed)
    t0 = time.time()
    model, losses = train(
        model,
        corpus,
        steps=conf.steps,
        batch=conf.batch,
        seq=conf.seq,
        lr=conf.lr,
        mesh=mesh,
        seed=conf.seed,
        log_every=max(conf.steps // 5, 1),
        checkpoint_dir=conf.checkpoint_dir,
        checkpoint_every=conf.checkpoint_every,
        schedule=conf.schedule,
        grad_clip=conf.grad_clip,
        logit_chunk=conf.logit_chunk,
    )
    dt = time.time() - t0
    steps_ran = len(losses)
    if not losses:
        losses = [float("nan")]
    res = {
        "loss_first": losses[0],
        "loss_last": float(np.mean(losses[-5:])),
        "steps": conf.steps,
        "steps_ran": steps_ran,
        "resumed": steps_ran < conf.steps,
        "params": model.num_params(),
        "tokens_per_s": steps_ran * conf.batch * conf.seq / dt,
        "wall_s": dt,
    }
    if valid is not None:
        if len(valid) >= conf.seq + 1:
            from keystone_tpu_torch.evaluation.perplexity import evaluate_perplexity

            ev = evaluate_perplexity(
                model, valid, seq=conf.seq, batch=conf.batch, logit_chunk=conf.logit_chunk,
            )
            res["valid_loss"] = ev["loss"]
            res["valid_bits_per_token"] = ev["bits_per_token"]
            res["valid_perplexity"] = ev["perplexity"]
        else:
            logger.warning(
                "held-out tail (%d tokens) is shorter than one seq+1=%d "
                "window — skipping the perplexity evaluation the corpus "
                "flag promises; shorten --seq or grow the corpus",
                len(valid),
                conf.seq + 1,
            )
    logger.info(
        "lm: %d params, loss %.3f -> %.3f, %.0f tokens/s",
        res["params"], res["loss_first"], res["loss_last"], res["tokens_per_s"],
    )
    return res


def main(argv=None, device=None) -> dict:
    """CLI entry: the config flags plus ``--device`` (default: the card)."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    conf = parse_config(LMConfig, rest)
    return run(conf, device=device if device is not None else known.device)


if __name__ == "__main__":
    main()
