"""Preemption-safe checkpoint and resume for long solver fits and training
loops — port of ``keystone_tpu/core/checkpoint.py``.

A BCD fit's whole progress is its per-block model (the residual is
recomputed from it), so :func:`resumable_fit` runs the fit in chunks of
``every`` passes and checkpoints the model between chunks; a rerun with
the same directory resumes after the last completed chunk.
:class:`TrainCheckpointer` does the same for a training loop's state.

The JAX package writes orbax steps; here a step is a directory
``step_<N>`` holding ``leaves.pt``, a ``torch.save`` of the flat dict of
the state's tensors (index → CPU tensor; ``torch.load(weights_only=True)``
reads it), written under a temp name, fsynced and renamed, the parent
directory fsynced after. Beside the steps:

- ``digests_<N>.json``: each leaf's sha256, shape and dtype. A restore
  verifies them; a torn or corrupt newest step falls back to the previous
  one (:class:`CheckpointCorruptError`, a ``ckpt_fallback`` event). The
  shape and dtype check stands in for the JAX package's ``jax.eval_shape``
  template: a restored leaf must match what was saved, and, for a training
  loop, the caller's template leaf;
- ``fit_meta.json`` / ``train_meta.json``: the run's identity; a rerun
  against another fit's or run's directory raises;
- a fit's step also holds ``tree.pkl``: the fitted model's structure with
  its tensors replaced by leaf indices, so a resume rebuilds the model
  without a template fit.

Two steps are kept. A training loop's save is coordinated across
processes by :func:`keystone_tpu_torch.resilience.cluster.checkpoint_barrier`
(bounded by ``KEYSTONE_CKPT_BARRIER_S``); in one process it is a no-op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import pathlib
import pickle
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.serialization import _fsync_dir, map_leaves

logger = get_logger(__name__)

#: kill switch for per-leaf content digests (``0``/``off`` disables both
#: write and verify)
ENV_CKPT_DIGEST = "KEYSTONE_CKPT_DIGEST"
KEEP_STEPS = 2


class CheckpointCorruptError(RuntimeError):
    """A restored checkpoint's content digests (or its files) do not match
    what was saved — a torn write or on-disk corruption. Restore falls back
    to the next older step instead of resuming from garbage."""


class CheckpointMismatchError(ValueError):
    """The checkpoint's structure belongs to a DIFFERENT run (leaf count,
    shape or dtype mismatch). Falling back to an older step cannot fix
    pointing at the wrong directory, so restore fails loudly."""


def _digests_enabled() -> bool:
    return os.environ.get(ENV_CKPT_DIGEST, "").lower() not in ("0", "off")


def _host_bytes(t: torch.Tensor) -> memoryview:
    """The bytes of a CPU tensor in row-major order, without a copy when
    it is contiguous."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(_host_bytes(t)).hexdigest()


def _leaf_meta(t: torch.Tensor) -> dict:
    return {"shape": [int(s) for s in t.shape], "dtype": str(t.dtype).removeprefix("torch.")}


def flatten(tree) -> list[torch.Tensor]:
    """The state's tensors in walk order (lists, tuples, dicts and nodes,
    as :func:`keystone_tpu_torch.core.serialization.map_leaves` walks)."""
    leaves: list[torch.Tensor] = []
    map_leaves(leaves.append, tree, lambda x: isinstance(x, torch.Tensor))
    return leaves


@dataclasses.dataclass
class _Slot:
    """A leaf's place in a saved structure."""

    index: int


def _skeleton(tree):
    """``tree`` with its tensors replaced by :class:`_Slot` indices."""
    counter = iter(range(1 << 62))
    return map_leaves(lambda t: _Slot(next(counter)), tree, lambda x: isinstance(x, torch.Tensor))


def _fill(skeleton, leaves: list[torch.Tensor]):
    return map_leaves(lambda s: leaves[s.index], skeleton, lambda x: isinstance(x, _Slot))


class _StepStore:
    """The step directories of one checkpoint directory."""

    def __init__(self, directory: str):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def step_dir(self, step: int) -> pathlib.Path:
        return self.directory / f"step_{int(step)}"

    def digest_path(self, step: int) -> pathlib.Path:
        return self.directory / f"digests_{int(step)}.json"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.directory.glob("step_*"):
            try:
                steps.append(int(p.name.split("_", 1)[1]))
            except ValueError:
                continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, leaves: list[torch.Tensor], skeleton=None) -> dict:
        """Write ``leaves`` as step ``step`` (one host copy of each, saved
        and hashed), replacing a step of that number left by a torn
        restore; prune to the newest :data:`KEEP_STEPS`. Returns the
        step's bytes and digests. A leaf keeps its strides: a resumed
        product over a transposed weight takes the same kernel, and so
        the same bits, as the uninterrupted run's. The digests are taken
        on threads while ``torch.save`` writes (hashlib releases the
        interpreter lock), so the hashing costs no wall time of its own."""
        host = [t.detach().cpu() for t in leaves]
        with ThreadPoolExecutor(max_workers=4) as pool:
            hashing = [pool.submit(_sha256, t) for t in host] if _digests_enabled() else []
            self._write_step(step, host, skeleton)
            digests = [h.result() for h in hashing]
        record = {
            "step": int(step),
            "leaves": [_leaf_meta(t) for t in host],
            "bytes": int(sum(t.numel() * t.element_size() for t in host)),
        }
        if digests:
            record["digests"] = digests
        _write_json_atomic(self.digest_path(step), record)
        for old in self.all_steps()[:-KEEP_STEPS]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)
            with contextlib.suppress(OSError):
                self.digest_path(old).unlink()
        return record

    def _write_step(self, step: int, host: list, skeleton) -> None:
        """``leaves.pt`` (and ``tree.pkl``) under a temp directory, fsynced,
        then renamed to ``step_<step>``."""
        final = self.step_dir(step)
        tmp = self.directory / f".tmp_step_{int(step)}.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        try:
            from keystone_tpu_torch.resilience import faults

            with open(tmp / "leaves.pt", "wb") as f:
                torch.save({str(i): t for i, t in enumerate(host)}, f)
                faults.maybe_disk_full(key=int(step), note=f"step {step}")
                f.flush()
                os.fsync(f.fileno())
            if skeleton is not None:
                with open(tmp / "tree.pkl", "wb") as f:
                    pickle.dump(skeleton, f, protocol=pickle.HIGHEST_PROTOCOL)
                    f.flush()
                    os.fsync(f.fileno())
            _fsync_dir(str(tmp))
            if final.exists():
                # only reachable when a restore skipped this step as torn
                # and the interval was replayed: the state in memory IS
                # the good replacement
                logger.warning("replacing checkpoint step %d (torn or skipped on restore)", step)
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_dir(str(self.directory))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def load(self, step: int, where: str) -> tuple[list[torch.Tensor], object]:
        """Step ``step``'s leaves (CPU) and its saved skeleton (or None),
        checked against its sidecar: leaf count, shapes, dtypes and
        digests. A missing or unreadable part raises
        :class:`CheckpointCorruptError`."""
        d = self.step_dir(step)
        try:
            flat = torch.load(d / "leaves.pt", map_location="cpu", weights_only=True)
            leaves = [flat[str(i)] for i in range(len(flat))]
            skeleton = None
            if (d / "tree.pkl").exists():
                with open(d / "tree.pkl", "rb") as f:
                    skeleton = pickle.load(f)
        except (OSError, RuntimeError, KeyError, pickle.UnpicklingError, EOFError) as e:
            raise CheckpointCorruptError(f"{where} step {step}: unreadable ({e!r})") from e
        path = self.digest_path(step)
        if not path.exists():
            return leaves, skeleton
        try:
            record = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{where} step {step}: unreadable digest sidecar ({e!r}) — treating the "
                "step as torn"
            ) from e
        want = record.get("leaves") or []
        if len(want) != len(leaves):
            raise CheckpointCorruptError(
                f"{where} step {step}: {len(leaves)} restored leaves vs {len(want)} "
                "recorded — torn checkpoint"
            )
        bad = [i for i, (t, m) in enumerate(zip(leaves, want)) if _leaf_meta(t) != m]
        if bad:
            raise CheckpointCorruptError(
                f"{where} step {step}: leaf shape/dtype differs from the saved record at "
                f"index(es) {bad[:8]} — torn checkpoint"
            )
        digests = record.get("digests")
        if digests and _digests_enabled():
            with ThreadPoolExecutor(max_workers=4) as pool:
                got = list(pool.map(_sha256, leaves))
            bad = [i for i, (g, h) in enumerate(zip(got, digests)) if g != h]
            if bad:
                raise CheckpointCorruptError(
                    f"{where} step {step}: content digest mismatch on leaf index(es) "
                    f"{bad[:8]}{'...' if len(bad) > 8 else ''} — torn or corrupt checkpoint"
                )
        return leaves, skeleton


def _write_json_atomic(path: pathlib.Path, obj) -> None:
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(json.dumps(obj, indent=1))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(str(path.parent))


def _data_info(tree) -> dict:
    """Leaf shapes and a sha256 of the first leaf's first 64 values: a
    small content fingerprint of a fit's data or labels."""
    leaves = tree if isinstance(tree, (list, tuple)) else [tree]
    leaves = [torch.as_tensor(x) for x in leaves]
    shapes = [[int(s) for s in x.shape] for x in leaves]
    digest = ""
    if leaves:
        head = leaves[0].reshape(-1)[:64].detach().cpu()
        digest = hashlib.sha256(_host_bytes(head)).hexdigest()[:16]
    return {"shapes": shapes, "sample_sha": digest}


def _fit_meta(est, data, labels, n_valid) -> dict:
    """A fit's identity: the estimator's hyperparameters (``num_iter``
    excluded — resuming with a longer schedule is the point of chunking,
    and the over-trained guard covers a shorter one), the data and label
    shapes, a small content fingerprint, and ``n_valid``."""
    params = {f.name: getattr(est, f.name) for f in dataclasses.fields(est) if f.name != "num_iter"}
    return json.loads(json.dumps(
        {
            "estimator": type(est).__name__,
            "params": params,
            "data": _data_info(data),
            "labels": _data_info(labels),
            "n_valid": n_valid,
        },
        default=str,
    ))


def _check_meta(checkpoint_dir, meta_path, meta, what: str, legacy_defaults=None) -> None:
    """Raise if the sidecar identifies a different fit or run. Keys that an
    older sidecar lacks compare as ``legacy_defaults`` says; the
    informational ``cluster`` key is not compared."""
    if not meta_path.exists():
        return
    saved = json.loads(meta_path.read_text())
    saved.pop("cluster", None)
    meta = {k: v for k, v in meta.items() if k != "cluster"}
    if legacy_defaults:
        saved = {**legacy_defaults, **saved}
    if saved != meta:
        diff = [k for k in set(saved) | set(meta) if saved.get(k) != meta.get(k)]
        raise ValueError(
            f"{checkpoint_dir} holds checkpoints from a different {what} (mismatched: "
            f"{sorted(diff)}) — resuming would mix two runs; point at a fresh directory.\n"
            f"  saved:   { {k: saved.get(k) for k in diff} }\n"
            f"  current: { {k: meta.get(k) for k in diff} }"
        )


def _restore_latest_intact(store: _StepStore, where: str, check=None):
    """``(leaves, skeleton, step)`` of the NEWEST intact step, newest
    first: a torn or unreadable step (digest mismatch, missing file,
    exhausted IO retries) falls back to the next older one with a
    ``ckpt_fallback`` event. ``check(leaves)`` raises
    :class:`CheckpointMismatchError` for a different run, which is not
    retried. Returns ``(None, None, 0)`` when no step exists."""
    from keystone_tpu_torch.resilience import faults
    from keystone_tpu_torch.resilience.emit import decision
    from keystone_tpu_torch.resilience.retry import CHECKPOINT_POLICY

    last_err: Exception | None = None
    for step in reversed(store.all_steps()):

        def attempt(step=step):
            faults.maybe_raise("ckpt.restore", note=where)
            return store.load(step, where)

        try:
            leaves, skeleton = CHECKPOINT_POLICY.call(attempt, label="ckpt.restore")
            if check is not None:
                check(leaves)
        except CheckpointMismatchError:
            raise  # a different run, not corruption
        except Exception as e:  # noqa: BLE001 — the corruption/IO family
            last_err = e
            decision("ckpt_fallback", counter="ckpt_fallbacks", step=step, error=repr(e))
            logger.warning(
                "checkpoint step %d of %s is torn or unreadable (%r); falling back to the "
                "previous step", step, where, e,
            )
            continue
        if last_err is not None:
            logger.warning("resumed %s from step %d after newer step(s) failed (%r)",
                           where, step, last_err)
        return leaves, skeleton, step
    if last_err is not None:
        raise last_err
    return None, None, 0


def _save_step(store: _StepStore, step: int, leaves: list, skeleton=None) -> dict:
    """Save under ``CHECKPOINT_POLICY``: a flaky filesystem must not kill a
    run at its survival point. The ``ckpt.save`` fault fires before the
    write; ``ckpt.disk_full`` (ENOSPC, not retried) inside it. The save's
    seconds go to the ``ckpt_save_seconds`` timer and its bytes to the
    ``ckpt_save_bytes`` gauge."""
    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.resilience import faults
    from keystone_tpu_torch.resilience.retry import CHECKPOINT_POLICY

    def attempt():
        faults.maybe_raise("ckpt.save", note=f"step {step}")
        return store.save(step, leaves, skeleton)

    t0 = time.perf_counter()
    record = CHECKPOINT_POLICY.call(attempt, label="ckpt.save")
    record["save_s"] = time.perf_counter() - t0
    reg = metrics.get_registry()
    reg.timer("ckpt_save_seconds").observe(record["save_s"])
    reg.gauge("ckpt_save_bytes").set(record["bytes"])
    return record


def checkpointed_fit(
    est,
    data,
    labels,
    *,
    checkpoint_dir: str = "",
    every: int = 1,
    n_valid: int | None = None,
):
    """The model CLIs' wiring: :func:`resumable_fit` when
    ``checkpoint_dir`` is set, ``est.fit`` otherwise."""
    if checkpoint_dir:
        return resumable_fit(
            est, data, labels, checkpoint_dir=checkpoint_dir, every=every, n_valid=n_valid
        )
    return est.fit(data, labels, n_valid=n_valid)


def resumable_fit(
    est,
    data,
    labels,
    *,
    checkpoint_dir: str,
    every: int = 1,
    n_valid: int | None = None,
):
    """Run ``est.fit`` (a Block[Weighted]LeastSquaresEstimator) in chunks
    of ``every`` BCD passes, checkpointing the model between chunks.

    If ``checkpoint_dir`` holds chunks of an interrupted run of the same
    fit, the fit resumes after the last completed pass. Each chunk
    re-enters the fit (warm-started from the model), recomputing the
    pass-invariant setup, so ``every=1`` costs about a setup a pass."""
    if every < 1:
        raise ValueError(f"every={every}: must be >= 1")
    total = est.num_iter
    meta = _fit_meta(est, data, labels, n_valid)
    store = _StepStore(checkpoint_dir)
    meta_path = store.directory / "fit_meta.json"
    model = None
    done = 0
    latest = store.latest_step()
    if latest is not None:
        _check_meta(checkpoint_dir, meta_path, meta, "fit")
        if latest > total:
            raise ValueError(
                f"{checkpoint_dir} holds a {latest}-pass checkpoint but this fit runs only "
                f"{total} passes — refusing to return an over-trained model; point at a "
                "fresh directory"
            )
        leaves, skeleton, done = _restore_latest_intact(store, checkpoint_dir)
        if skeleton is not None:
            device = flatten(data)[0].device if flatten(data) else torch.device("cpu")
            model = _fill(skeleton, [t.to(device) for t in leaves])
            logger.info("resuming fit from %s: %d/%d passes done", checkpoint_dir, done, total)
        else:
            done = 0
    if latest is None or not meta_path.exists():
        # overwrite when no checkpoint exists yet: a crashed first-chunk
        # run may have left a stale meta
        _write_json_atomic(meta_path, meta)
    while done < total:
        step = min(every, total - done)
        chunk_est = dataclasses.replace(est, num_iter=step)
        model = chunk_est.fit(data, labels, n_valid=n_valid, init=model)
        done += step
        _save_step(store, done, flatten(model), _skeleton(model))
    if model is None:  # total == 0
        model = dataclasses.replace(est, num_iter=0).fit(data, labels, n_valid=n_valid)
    return model


def checkpoint_barrier(step: int, phase: str = "") -> None:
    """Agree on ``step`` across processes before any writes (and, with
    ``phase="saved"``, after the write): every process arrives or the save
    raises :class:`~keystone_tpu_torch.resilience.cluster.ClusterBarrierError`
    within ``KEYSTONE_CKPT_BARRIER_S``. One process has nothing to agree
    with."""
    from keystone_tpu_torch.resilience.cluster import checkpoint_barrier as _barrier

    if phase:
        _barrier(step, phase=phase)
    else:
        _barrier(step)


class TrainCheckpointer:
    """Step-indexed checkpointing for a training loop: the same step
    store, digests and identity check as :func:`resumable_fit`, over any
    state of tensors (model and optimizer state) whose schedule the loop
    owns::

        ckpt = TrainCheckpointer(dir, meta)
        state, start = ckpt.restore(state)   # (state, 0) if fresh
        for step in range(start, total):
            state = train_step(state)
            if (step + 1) % every == 0:
                ckpt.save(state, step + 1)

    ``restore`` writes the restored values INTO the template's tensors (a
    model updated in place stays the caller's object). A resume is exact
    when step ``i``'s batch derives from ``(seed, i)`` alone.
    ``cluster_info`` rides in the sidecar and is not compared, so any
    process count may restore a checkpoint.

    Across processes a save is coordinated: every process meets at
    :func:`checkpoint_barrier`, process 0 alone writes the replicated
    state, and every process meets again before going on, so no process
    runs ahead of a checkpoint that is not on disk yet. Every process
    restores."""

    def __init__(self, checkpoint_dir: str, meta: dict, legacy_defaults: dict | None = None,
                 cluster_info: dict | None = None):
        self._dir = checkpoint_dir
        self._meta = json.loads(json.dumps(meta, default=str))
        self._legacy = legacy_defaults or {}
        self._cluster_info = (
            json.loads(json.dumps(cluster_info, default=str)) if cluster_info else None
        )
        self._store = _StepStore(checkpoint_dir)
        self._meta_path = self._store.directory / "train_meta.json"
        self.last_save: dict | None = None

    def restore(self, template):
        """``(state, start_step)``: the newest intact step's values copied
        into ``template``'s tensors, or ``(template, 0)`` when the directory
        is fresh. Raises on a different run: another meta, leaf count,
        shape or dtype."""
        latest = self._store.latest_step()
        if latest is None or latest == 0:
            self._write_meta()
            return template, 0
        _check_meta(self._dir, self._meta_path, self._meta, "training run",
                    legacy_defaults=self._legacy)
        targets = flatten(template)

        def check(leaves):
            if len(leaves) != len(targets):
                raise CheckpointMismatchError(
                    f"{self._dir} checkpoint has {len(leaves)} leaves; this training run's "
                    f"state has {len(targets)} — the directory belongs to a different run"
                )
            bad = [i for i, (a, b) in enumerate(zip(leaves, targets))
                   if _leaf_meta(a) != _leaf_meta(b)]
            if bad:
                raise CheckpointMismatchError(
                    f"{self._dir} checkpoint leaves {bad[:8]} differ in shape or dtype from "
                    "this training run's state — the directory belongs to a different run"
                )

        leaves, _, step = _restore_latest_intact(self._store, self._dir, check=check)
        self._write_meta()
        if leaves is None:
            return template, 0
        with torch.no_grad():
            for t, v in zip(targets, leaves):
                t.copy_(v)
        logger.info("resuming training from %s: step %d", self._dir, step)
        return template, step

    def save(self, state, step: int) -> dict:
        """Checkpoint ``state`` as step ``step``; returns the step's record
        (bytes, leaf shapes, digests) and keeps it as ``last_save``."""
        from keystone_tpu_torch.resilience.cluster import process_count, process_index

        checkpoint_barrier(step)
        if process_index() == 0:
            self.last_save = _save_step(self._store, step, flatten(state))
        else:
            self.last_save = {"step": int(step), "writer": 0}
        if process_count() > 1:
            checkpoint_barrier(step, phase="saved")
        return self.last_save

    def _write_meta(self) -> None:
        from keystone_tpu_torch.resilience.cluster import process_index

        if process_index() != 0:
            return
        meta = dict(self._meta)
        if self._cluster_info:
            meta["cluster"] = self._cluster_info
        _write_json_atomic(self._meta_path, meta)


def read_step(checkpoint_dir: str, step: int | None = None) -> tuple[list[torch.Tensor], int]:
    """``(leaves, step)`` of step ``step`` (default: the newest) of a
    checkpoint directory, verified against its sidecar, on the CPU."""
    store = _StepStore(checkpoint_dir)
    step = store.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"{checkpoint_dir} holds no checkpoint step")
    leaves, _ = store.load(step, checkpoint_dir)
    return leaves, step
