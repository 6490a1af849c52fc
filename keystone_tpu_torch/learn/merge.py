"""The fit protocol's third verb, ``merge``, and fit-state persistence —
port of ``keystone_tpu/learn/merge.py``.

``fit_stats_init/update/finalize`` stream one corpus through one process.
Online learning needs two more freedoms:

- **time** — fold today's chunks into the state accumulated yesterday,
  which needs the state to persist (:func:`save_fit_state` /
  :func:`load_fit_state`, digest-checked so a torn or tampered file is
  refused loudly);
- **space** — combine states accumulated apart, which needs a commutative
  and associative pairwise :func:`fit_stats_merge`.

Merge per state type:

- :class:`~keystone_tpu_torch.ops.linear.NormalEqState` keeps its Gram
  centred about a running mean, so the merge is Chan's pairwise update:
  sums add, and a rank-1 mean-difference term ``(n·m/(n+m))·δδᵀ``
  re-centres the combined Gram;
- :class:`~keystone_tpu_torch.ops.weighted_linear.WeightedEqState` holds
  raw per-class sums: the merge is leaf-wise addition.

A state file keeps ONE host copy of the state: each tensor is copied to
the host once and pickled from that copy while a thread runs a sha256
over the bytes as they are written; the load verifies the digest by
reading the file once, then unpickles it. At the MNIST width (D =
16,384) the (D, D) f32 Gram alone is 1.07 GB.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
import queue
import threading
from typing import Any

import torch

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.serialization import _from_host, _to_host, atomic_write

logger = get_logger("keystone_tpu_torch.learn.merge")

_MAGIC_STATE = b"KSTTS1\n"
_DIGEST_LEN = 64  # hex sha256
_READ_CHUNK = 16 << 20


class FitStateError(ValueError):
    """A fit-state file is torn, tampered or structurally wrong — digest
    mismatch, bad magic, or a state whose shapes disagree with the
    estimator that is to finalize it. Loud by design: statistics merged
    onto a corrupt base would poison every model refit from then on."""


# ------------------------------------------------------------------- merge


def _merge_normal_eq(a, b):
    """Chan's pairwise merge of two centred normal-equation states. An
    empty side (n = 0) contributes nothing: the rank-1 weight n·m/(n+m)
    and the mean step m/(n+m) both vanish, as in the per-chunk update."""
    from keystone_tpu_torch.ops.linear import NormalEqState

    n_new = torch.clamp_min(a.n + b.n, 1.0)
    w = a.n * b.n / n_new
    da = b.mean_a - a.mean_a
    db = b.mean_b - a.mean_b
    ata = a.ata + b.ata
    ata.add_(torch.outer(da, da).mul_(w))
    return NormalEqState(
        ata=ata,
        atb=(a.atb + b.atb).add_(torch.outer(da, db).mul_(w)),
        mean_a=a.mean_a + (b.n / n_new) * da,
        mean_b=a.mean_b + (b.n / n_new) * db,
        n=a.n + b.n,
    )


def _merge_additive(a, b):
    return type(a)(**{f.name: getattr(a, f.name) + getattr(b, f.name)
                      for f in dataclasses.fields(a)})


def _shapes(state) -> list[tuple]:
    return [tuple(getattr(state, f.name).shape) for f in dataclasses.fields(state)]


def fit_stats_merge(a: Any, b: Any) -> Any:
    """Merge two accumulated fit states of the same type and shape:
    commutative and associative, so a corpus split k ways folds to the same
    statistics in any order. Raises :class:`FitStateError` on a type or
    shape disagreement — states of different pipelines must fail at the
    merge, not at a finalize later."""
    from keystone_tpu_torch.ops.linear import NormalEqState
    from keystone_tpu_torch.ops.weighted_linear import WeightedEqState

    if type(a) is not type(b):
        raise FitStateError(
            f"cannot merge fit states of different types: {type(a).__name__} vs "
            f"{type(b).__name__}"
        )
    if not isinstance(a, (NormalEqState, WeightedEqState)):
        raise FitStateError(f"no merge rule for fit-state type {type(a).__name__}")
    if _shapes(a) != _shapes(b):
        raise FitStateError(
            f"cannot merge fit states of different shapes: {_shapes(a)} vs {_shapes(b)} "
            "(different pipelines?)"
        )
    if isinstance(a, NormalEqState):
        return _merge_normal_eq(a, b)
    # every field of the weighted state is a raw masked sum
    return _merge_additive(a, b)


# ------------------------------------------------------------ persistence


@dataclasses.dataclass
class FitState:
    """One loaded fit-state artifact: the accumulated statistics and what a
    refit needs to keep folding and re-finalizing — the estimator, the
    featurize prefix the fused segment applies to NEW chunks only, the
    feature-block ``widths`` finalize pins block edges with, and free-form
    ``meta`` (the refit daemon keeps its offsets and version here)."""

    state: Any
    est: Any = None
    prefix: tuple = ()
    widths: tuple | None = None
    meta: dict = dataclasses.field(default_factory=dict)


class _HashingWriter:
    """A file wrapper whose written bytes a thread hashes, in order, while
    the writer goes on (hashlib releases the interpreter lock): the sha256
    of a 1 GB state costs no wall time of its own. The pickler hands
    ``write`` immutable bytes or views of arrays the payload keeps alive,
    so the queue may hold them until hashed."""

    def __init__(self, f):
        self._f = f
        self._sha = hashlib.sha256()
        self._queue: queue.Queue = queue.Queue(maxsize=64)
        self._thread = threading.Thread(target=self._hash, name="fit-state-sha256", daemon=True)
        self._thread.start()

    def _hash(self) -> None:
        while (b := self._queue.get()) is not None:
            self._sha.update(b)

    def write(self, b) -> int:
        n = self._f.write(b)
        self._queue.put(b)
        return n

    def hexdigest(self) -> str:
        """The digest of everything written; ends the hashing thread."""
        self._queue.put(None)
        self._thread.join()
        return self._sha.hexdigest()


def save_fit_state(
    state: Any,
    path: str,
    *,
    est: Any = None,
    prefix: Any = (),
    widths: Any = None,
    **meta: Any,
) -> str:
    """Persist accumulated fit statistics (with the estimator and prefix a
    refit resumes with) to ``path``, atomically, with a sha256 over the
    payload so :func:`load_fit_state` refuses a torn or corrupt file.
    Returns the hex digest."""
    payload = {
        "version": 1,
        "state": _to_host(state),
        "est": _to_host(est),
        "prefix": tuple(_to_host(p) for p in (prefix or ())),
        "widths": tuple(widths) if widths else None,
        "meta": dict(meta),
    }
    with atomic_write(path) as f:
        f.write(_MAGIC_STATE)
        slot = f.tell()
        f.write(b"0" * _DIGEST_LEN + b"\n")
        out = _HashingWriter(f)
        try:
            pickle.dump(payload, out, protocol=pickle.HIGHEST_PROTOCOL)
        finally:
            digest = out.hexdigest()
        end = f.tell()
        f.seek(slot)
        f.write(digest.encode())
        f.seek(end)
    return digest


def load_fit_state(path: str, device=None) -> FitState:
    """Load a :func:`save_fit_state` artifact, its tensors on ``device``
    (the card unless the caller asks for the CPU), after verifying the
    stored digest over the payload bytes. Raises :class:`FitStateError`
    on bad magic or a digest mismatch (the ``refit.state_digest`` fault
    site drills the mismatch)."""
    from keystone_tpu_torch.core.runtime import resolve_device
    from keystone_tpu_torch.resilience import faults as _faults

    device = resolve_device(device)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC_STATE)) != _MAGIC_STATE:
            raise FitStateError(f"{path} is not a keystone_tpu_torch fit-state file")
        digest = f.readline().strip().decode(errors="replace")
        start = f.tell()
        sha = hashlib.sha256()
        while chunk := f.read(_READ_CHUNK):
            sha.update(chunk)
        actual = sha.hexdigest()
        if actual != digest or _faults.fire("refit.state_digest", path):
            raise FitStateError(
                f"{path}: fit-state digest mismatch (stored {digest[:12]}…, computed "
                f"{actual[:12]}…) — torn write or corruption; refusing to fold new data "
                "onto a corrupt base"
            )
        f.seek(start)
        payload = pickle.load(f)
    return FitState(
        state=_from_host(payload["state"], device),
        est=_from_host(payload.get("est"), device),
        prefix=tuple(_from_host(p, device) for p in payload.get("prefix") or ()),
        widths=payload.get("widths"),
        meta=dict(payload.get("meta") or {}),
    )


# ------------------------------------------------------- cross-host merge


def merge_over_group(state: Any, group=None) -> Any:
    """Every process's accumulated state merged in rank order, on every
    process: each field is gathered over the process group and the states
    are folded with :func:`fit_stats_merge`, rank 0 first, so every process
    computes the same merged state from the same inputs. ``group`` (an
    :class:`~keystone_tpu_torch.parallel.collectives.AxisGroup`, the data
    axis's line of a mesh across processes,
    :func:`keystone_tpu_torch.parallel.mesh.data_group`) folds only its
    processes' states, in data order: the replicas of one data row along a
    model axis then count its rows once, and a (data 2, model 2) fit folds
    the states a (data 2) fit folds, in the same order. A group of one
    returns ``state``. A transport failure raises."""
    from keystone_tpu_torch.parallel import multihost

    size = multihost.process_count() if group is None else group.size
    if size == 1:
        return state
    names = [f.name for f in dataclasses.fields(state)]
    gathered = {
        name: multihost.all_gather(getattr(state, name).reshape(-1), group)
        for name in names
    }
    merged = None
    for r in range(size):
        peer = type(state)(**{
            name: gathered[name][r].reshape(getattr(state, name).shape) for name in names
        })
        merged = peer if merged is None else fit_stats_merge(merged, peer)
    return merged


def allmerge_fit_state(state: Any, timeout_s: float = 60.0) -> Any:
    """Merge this process's accumulated fit state with every peer's; every
    process must call it, and every process returns the same merged state
    (states merged in rank order, :func:`merge_over_group`). One process
    has no peer and gets its own state back. A transport failure degrades
    to the local state with a warning — a lost merge loses freshness, never
    the run. ``timeout_s`` is the reference's argument: the group's own
    timeout bounds each collective."""
    del timeout_s
    try:
        return merge_over_group(state)
    except FitStateError:
        raise
    except Exception as e:  # noqa: BLE001 — degraded, never fatal
        logger.warning(
            "fit-state merge over the process group failed (%r); keeping this "
            "process's state only",
            e,
        )
        return state
