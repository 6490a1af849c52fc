"""Byte-level text corpora for the LM — copy of
``keystone_tpu/loaders/text.py`` (numpy only).

A file, or a directory of files, becomes one contiguous uint8 token
stream: byte-level tokenization (vocab 256) needs no vocabulary artifact
and makes every file valid input. The train/validation split happens on
the stream, not the files, so a single-file corpus still yields a
held-out tail.
"""

from __future__ import annotations

import pathlib

import numpy as np

BYTE_VOCAB = 256


def load_bytes(path: str | pathlib.Path, pattern: str = "*.txt") -> np.ndarray:
    """One file, or every ``pattern``-matching file under a directory
    (sorted, concatenated) → uint8 token array. The default pattern keeps
    checkpoints and archives beside a corpus directory out of the token
    stream."""
    p = pathlib.Path(path)
    if p.is_dir():
        files = sorted(f for f in p.rglob(pattern) if f.is_file())
        if not files:
            raise FileNotFoundError(f"no {pattern} files under {p}")
        data = b"".join(f.read_bytes() for f in files)
    else:
        data = p.read_bytes()
    if not data:
        raise ValueError(f"{p} is empty")
    return np.frombuffer(data, dtype=np.uint8)


def train_valid_split(
    tokens: np.ndarray, valid_frac: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic head/tail split of the token stream. The tail is the
    held-out set (no shuffling: adjacent bytes are the dependency being
    modeled, so a shuffled split would leak)."""
    if not 0.0 < valid_frac < 1.0:
        raise ValueError(f"valid_frac={valid_frac}: need 0 < f < 1")
    cut = max(1, int(len(tokens) * (1.0 - valid_frac)))
    if cut >= len(tokens):
        raise ValueError(f"corpus of {len(tokens)} tokens leaves no validation tail")
    return tokens[:cut], tokens[cut:]


def load_text_corpus(
    path: str | pathlib.Path, valid_frac: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """(train, valid) int32 byte-token streams; the valid tail is what
    :func:`keystone_tpu_torch.evaluation.perplexity.evaluate_perplexity`
    scores."""
    toks = load_bytes(path).astype(np.int32)
    return train_valid_split(toks, valid_frac)
