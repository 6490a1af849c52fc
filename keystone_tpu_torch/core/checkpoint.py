"""Fit checkpointing — port of ``keystone_tpu/core/checkpoint.py``'s
:func:`checkpointed_fit`, the wiring behind the model CLIs'
``--checkpoint-dir`` flag. Only its branch without a directory is ported:
the checkpoint store itself waits for the state slice (ROADMAP A7)."""

from __future__ import annotations


def checkpointed_fit(
    est,
    data,
    labels,
    *,
    checkpoint_dir: str = "",
    every: int = 1,
    n_valid: int | None = None,
):
    """``est.fit(data, labels, n_valid=...)``. A ``checkpoint_dir`` asks for
    the resumable fit, which raises until the checkpoint store is ported;
    ``every`` (BCD epochs a checkpoint) belongs to that fit."""
    if checkpoint_dir:
        raise NotImplementedError(
            "checkpointed_fit with a checkpoint_dir waits for the checkpoint "
            "store (ROADMAP A7)"
        )
    return est.fit(data, labels, n_valid=n_valid)
