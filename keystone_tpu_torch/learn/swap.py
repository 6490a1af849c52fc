"""Hot swap of a running server's model under traffic — port of
``keystone_tpu/learn/swap.py``.

The refit daemon publishes a new fitted pipeline; the server must start
answering with it without dropping a request and without trusting it
blindly:

1. **load through the spec check** — :func:`keystone_tpu_torch.core.
   serialization.load_fitted` refuses a checkpoint whose structure drifted
   from the code;
2. **capture before commit** — the candidate is exported over the SAME
   batch buckets as the incumbent (:class:`~keystone_tpu_torch.serve.
   export.ExportedApply`: on the card, one CUDA graph a bucket, captured in
   its own memory pool while the incumbent's graphs keep replaying) and
   probed with one row; until then the incumbent serves every request;
3. **commit atomically** — :meth:`ServeApp.swap_exported
   <keystone_tpu_torch.serve.server.ServeApp.swap_exported>` replaces the
   micro-batcher under the server's model lock, then drains the old one:
   queued requests finish on the model they were admitted under;
4. **fail loudly, keep the last good version** — any failure (spec drift,
   a capture error, the ``serve.swap_fail`` drill) leaves the incumbent
   serving, counts ``serve_model_swap_failed`` and emits a ``model_swap``
   event with ``action="rollback"``.

Until the commit both models are resident on the card. Once the old
batcher has drained, the old model's graphs are released on the
swapper's thread (:meth:`~keystone_tpu_torch.serve.export.ExportedApply.
release`), where no capture runs.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any

import numpy as np

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.resilience import faults as _faults

logger = get_logger("keystone_tpu_torch.learn.swap")


class SwapError(RuntimeError):
    """A hot swap failed before commit; the prior version still serves
    (nothing was committed)."""


def version_of(path: str, meta: dict | None = None) -> str:
    """The version a checkpoint serves under: its ``save_fitted``
    ``version`` meta when present, else the file's basename."""
    if meta and meta.get("version") is not None:
        return str(meta["version"])
    return os.path.basename(path)


class ModelSwapper:
    """Hot swaps for one :class:`~keystone_tpu_torch.serve.server.ServeApp`:
    load → spec check → export → probe → commit, rolling back by not
    committing on any failure. ``source_path`` is the default reload
    source (the checkpoint the server loaded, or the refit daemon's
    ``current.kst``): ``POST /admin/reload`` without a path and SIGHUP
    reload from it. Swaps, and the shadow's exports, run one at a time."""

    def __init__(self, app: Any, *, source_path: str | None = None):
        self.app = app
        self.source_path = source_path
        self._swap_idx = itertools.count()
        self._lock = threading.Lock()
        self.last: dict | None = None

    def swap_to_path(self, path: str | None = None) -> dict:
        """Load the fitted pipeline at ``path`` (default: the source path)
        and hot-swap it in. Returns ``{old_version, new_version, swaps,
        wall_s, load_s, export_s}``; raises :class:`SwapError` (the prior
        version still serving) on any failure."""
        path = path or self.source_path
        if not path:
            raise SwapError(
                "no model path to reload from (server was not started from a "
                "checkpoint; pass an explicit path)"
            )
        with self._lock:
            idx = next(self._swap_idx)
            old_version = getattr(self.app, "model_version", None)
            t0 = time.perf_counter()
            exported = None
            try:
                from keystone_tpu_torch.core.serialization import load_fitted

                pipe, meta = load_fitted(path, with_meta=True, device=self.app.device)
                new_version = version_of(path, meta)
                t_load = time.perf_counter()
                exported = self._export(pipe, meta)
                t_export = time.perf_counter()
                if _faults.fire("serve.swap_fail", idx):
                    raise SwapError(f"injected swap failure (serve.swap_fail, swap {idx})")
                # one real row through the candidate before commit: a
                # pipeline that captures but cannot answer must roll back
                probe = np.zeros((1, *exported.row_shape), exported.dtype)
                _to_numpy(exported(probe))
            except Exception as e:  # noqa: BLE001 — every failure rolls back
                if exported is not None:
                    exported.release()
                self._observe(
                    "rollback",
                    old_version=old_version,
                    new_version=version_of(path),
                    path=path,
                    error=f"{type(e).__name__}: {str(e)[:200]}",
                )
                logger.warning("model swap to %s failed (%r); still serving %r",
                               path, e, old_version)
                if isinstance(e, SwapError):
                    raise
                raise SwapError(
                    f"swap to {path} failed; still serving {old_version!r} "
                    f"({type(e).__name__}: {e})"
                ) from e
            res = self._commit(exported, new_version, path=path, t0=t0)
            res.update(load_s=round(t_load - t0, 4), export_s=round(t_export - t_load, 4),
                       capture_s=round(exported.cold_start_s, 4))
            self.last = res
            return res

    def promote(self, exported: Any, version: str) -> dict:
        """Commit an already-exported, probed candidate (the shadow's
        promotion: it has been scoring live traffic)."""
        with self._lock:
            return self._commit(exported, version, path=None, t0=time.perf_counter())

    def export_candidate(self, pipe: Any, meta: dict) -> Any:
        """:meth:`_export` under the swap lock (the shadow's start), so two
        captures never run at once."""
        with self._lock:
            return self._export(pipe, meta)

    def retire(self, exported: Any) -> None:
        """Release a candidate that will not serve (a refused or stopped
        shadow) under the swap lock: its graphs are destroyed where no
        capture runs."""
        with self._lock:
            exported.release()

    # ---------------------------------------------------------- helpers

    def _export(self, pipe: Any, meta: dict) -> Any:
        """Export the candidate over the incumbent's buckets, row shape and
        device. The row shape is the serving contract: a candidate that
        needs other rows is drift at the traffic level and fails here,
        before commit."""
        from keystone_tpu_torch.serve.export import ExportedApply

        incumbent = self.app.exported
        if incumbent is None:
            raise SwapError("server has no exported pipeline to swap")
        sample = meta.get("sample")
        if sample is None:
            sample = np.zeros((1, *incumbent.row_shape), incumbent.dtype)
        sample = np.asarray(sample)
        if tuple(sample.shape[1:]) != tuple(incumbent.row_shape):
            raise SwapError(
                f"candidate row shape {tuple(sample.shape[1:])} != served "
                f"{tuple(incumbent.row_shape)}"
            )
        return ExportedApply(pipe, sample, buckets=incumbent.buckets, device=incumbent.device)

    def _commit(self, exported: Any, version: str, *, path: str | None, t0: float) -> dict:
        old_version = getattr(self.app, "model_version", None)
        self.app.swap_exported(exported, version=version)
        wall = time.perf_counter() - t0
        _metrics.get_registry().counter("serve_model_swaps").inc()
        self._observe("swap", old_version=old_version, new_version=version, path=path,
                      swaps=self.app.swap_count, wall_s=round(wall, 3))
        logger.info("model swapped: %r -> %r in %.2fs (swap #%d)",
                    old_version, version, wall, self.app.swap_count)
        return {
            "old_version": old_version,
            "new_version": version,
            "swaps": self.app.swap_count,
            "wall_s": round(wall, 3),
        }

    def _observe(self, action: str, **fields: Any) -> None:
        if action == "rollback":
            _metrics.get_registry().counter("serve_model_swap_failed").inc()
        log = _events.active()
        if log is not None:
            log.emit("model_swap", action=action, **fields)


def _to_numpy(out) -> np.ndarray:
    """A served result on the host (waits for the device)."""
    if hasattr(out, "detach"):
        return out.detach().cpu().numpy()
    return np.asarray(out)
