"""The refit daemon: fold live labeled chunks, re-finalize, republish —
port of ``keystone_tpu/learn/refit.py``.

``python -m keystone_tpu_torch.learn.refit <state> --watch <dir>`` tails a
directory of labeled chunks (``*.npz`` with ``data`` and ``labels``,
dropped in atomically: a temp name, then a rename; never deleted) and
closes the online-learning loop:

- each NEW chunk is folded through the same fused featurize+accumulate
  segment the original fit used (:func:`keystone_tpu_torch.plan.executor.
  fit_stream` with the persisted state as ``init_state``, the int8 Gram —
  kernel K1 on the card — when the state was accumulated with it): old
  rows are never featurized again, a chunk costs O(chunk·D²) however much
  history the state holds;
- the re-finalize is the estimator's ``fit_stats_finalize`` (O(D³),
  N-independent), published as a **versioned** fitted pipeline
  (``model_v000042.kst``, plus an atomically replaced ``current.kst``)
  through :func:`keystone_tpu_torch.core.serialization.save_fitted`, ready
  for the server's ``/admin/reload`` (``--notify URL`` posts it);
- offsets persist **in the state file's own meta** (the ``processed``
  list rides the digest-checked artifact), so delivery is at-least-once
  without double counting: a crash after a fold but before the state
  save resumes from the last durable state and folds the unacked chunks
  again;
- a chunk that will not read (a truncated write, or the
  ``refit.corrupt_chunk`` drill) or does not fit the state is skipped
  loudly (a counter and a ``refit`` event); a state file that fails its
  digest (``refit.state_digest``) refuses to start.

The daemon is one process; states accumulated apart combine with
:func:`keystone_tpu_torch.learn.merge.fit_stats_merge`.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import sys
import threading
import time
from typing import Any

import numpy as np
import torch

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device, synchronize
from keystone_tpu_torch.learn.merge import FitStateError, load_fit_state, save_fit_state
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.resilience import faults as _faults

logger = get_logger("keystone_tpu_torch.learn.refit")

#: the atomically replaced pointer to the newest published model — what a
#: server's reload endpoint and SIGHUP read
CURRENT_MODEL = "current.kst"


def _host_rows(data: Any) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def bootstrap_state(chain: Any, data: Any, labels: Any, state_path: str, *, device=None,
                    **meta: Any):
    """Fit the initial corpus through the fused streaming path on
    ``device`` (the card unless the caller asks for the CPU) and persist
    the accumulated state, which the refit daemon resumes from. Returns
    ``(fitted_pipeline, state)``. The state file carries the estimator,
    prefix, block widths, the Gram operator the plan chose, a 1-row input
    sample (so a server can export reloads) and the row count."""
    from keystone_tpu_torch.core.pipeline import Pipeline
    from keystone_tpu_torch.plan import executor as _executor
    from keystone_tpu_torch.plan.executor import _prefix_nodes
    from keystone_tpu_torch.plan.fused_fit import plan_fit

    device = resolve_device(device)
    plan = plan_fit(chain, data, labels, device=device)
    if not plan.fit or not plan.fit.fused:
        raise FitStateError(
            "bootstrap needs a fully fusable streaming-fit chain (fallback reason in the "
            f"plan decisions: {[d for d in plan.decisions if d.get('action') == 'fit_fallback']})"
        )
    state = _executor.fit_stream(plan, data, labels)
    model = chain.est.fit_stats_finalize(state, widths=plan.fit.widths)
    save_fit_state(
        state,
        state_path,
        est=chain.est,
        prefix=tuple(_prefix_nodes(chain)),
        widths=plan.fit.widths,
        gram=plan.fit.gram,
        sample=_host_rows(data[:1]),
        rows=int(data.shape[0]),
        version=0,
        processed=[],
        **meta,
    )
    return Pipeline.of(chain.prefix, model), state


class RefitDaemon:
    """One watch loop over a labeled-chunk directory. Construction loads
    (and digest-verifies) the state onto ``device`` (the card unless the
    caller asks for the CPU); :meth:`run_once` folds every new chunk and
    republishes when anything changed; :meth:`run` loops until stopped."""

    def __init__(
        self,
        state_path: str,
        watch_dir: str,
        *,
        out_dir: str | None = None,
        notify_url: str | None = None,
        device=None,
    ):
        self.state_path = state_path
        self.watch_dir = watch_dir
        self.out_dir = out_dir or os.path.dirname(os.path.abspath(state_path))
        self.notify_url = notify_url
        self.device = resolve_device(device)
        self.fs = load_fit_state(state_path, device=self.device)  # loud on a bad digest
        if self.fs.est is None:
            raise FitStateError(
                f"{state_path} carries no estimator — it was saved without est=; the "
                "refit daemon cannot re-finalize it"
            )
        self.state = self.fs.state
        self.processed: set[str] = set(self.fs.meta.get("processed") or ())
        self.version = int(self.fs.meta.get("version") or 0)
        self.rows_total = int(self.fs.meta.get("rows") or 0)
        self._plan = None
        self._stop = threading.Event()
        #: the last publish's parts (s) and the state file's bytes
        self.last_publish: dict = {}
        os.makedirs(self.out_dir, exist_ok=True)

    # ------------------------------------------------------------- scan

    def pending(self) -> list[str]:
        """New chunk files in arrival (name) order: producers name chunks
        monotonically, so sorted order is stream order."""
        try:
            names = os.listdir(self.watch_dir)
        except OSError:
            return []
        return sorted(f for f in names if f.endswith(".npz") and f not in self.processed)

    # ------------------------------------------------------------- fold

    def _label_width(self) -> int:
        s = self.state
        return int((s.atb if hasattr(s, "atb") else s.at_labels).shape[-1])

    def _ensure_plan(self, first_chunk: Any = None):
        """The fused fit plan, built ONCE from the state's own input sample
        (the first chunk when an old state carries none) and reused for
        every fold, with the Gram operator the state was accumulated with.
        A plan that will not fuse here is a daemon or config fault and
        raises :class:`FitStateError` (the daemon halts, the chunks stay
        pending); a malformed chunk fails later, in its fold, and is
        skipped alone."""
        if self._plan is not None:
            return self._plan
        from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Identity, Pipeline
        from keystone_tpu_torch.plan.fused_fit import _DEFAULT_FIT_CHUNK, plan_fit

        probe = self.fs.meta.get("sample")
        if probe is None:
            probe = first_chunk
        if probe is None:
            raise FitStateError(
                f"{self.state_path} carries no input sample and no chunk is available "
                "to probe the plan with"
            )
        probe = np.asarray(probe)[:1]
        labels_probe = np.zeros((1, self._label_width()), np.float32)
        prefix = Pipeline(nodes=tuple(self.fs.prefix)) if self.fs.prefix else Identity()
        chain = ChainedLabelEstimator(prefix=prefix, est=self.fs.est)
        # a 1-row probe gives the planner no row count to size chunks by:
        # pin the default, so an oversized chunk file still streams
        plan = plan_fit(
            chain, probe, labels_probe, device=self.device, chunk_size=_DEFAULT_FIT_CHUNK,
            gram=self.fs.meta.get("gram"),
        )
        if not plan.fit or not plan.fit.fused:
            raise FitStateError(
                "refit does not plan as a fused streaming fit (non-row-wise prefix or "
                "state over budget) — refusing to fold through another code path than "
                "the state was accumulated on"
            )
        d_state = int(self.state.ata.shape[0])
        if plan.fit.d != d_state:
            raise FitStateError(
                f"the state's sample featurizes to d={plan.fit.d} but its statistics "
                f"accumulate d={d_state} — stale or mismatched state file"
            )
        self._plan = plan
        return plan

    def fold(self, fname: str) -> int:
        """Fold one chunk file into the state; returns the rows folded (0
        when the chunk was skipped: unreadable, corrupt or malformed).
        Skipped chunks are marked processed, so one bad file cannot wedge
        the stream. The state is replaced last, so a failed fold leaves the
        accumulated statistics untouched."""
        reg = _metrics.get_registry()
        path = os.path.join(self.watch_dir, fname)
        try:
            if _faults.fire("refit.corrupt_chunk", fname):
                raise OSError(f"injected corrupt chunk (refit.corrupt_chunk, {fname})")
            with np.load(path) as z:
                data = np.asarray(z["data"])
                labels = np.asarray(z["labels"])
        except Exception as e:  # noqa: BLE001 — skip loudly, continue
            return self._skip(fname, e, reg)
        # outside the skip bracket: a plan that will not build is a config
        # fault that must HALT the daemon with every chunk still pending
        plan = self._ensure_plan(first_chunk=data)
        try:
            from keystone_tpu_torch.plan import executor as _executor

            state = _executor.fit_stream(plan, data, labels, init_state=self.state)
        except Exception as e:  # noqa: BLE001 — malformed chunk: skip
            return self._skip(fname, e, reg)
        self.state = state
        self.processed.add(fname)
        rows = int(data.shape[0])
        self.rows_total += rows
        reg.counter("refit_chunks_folded").inc()
        reg.counter("refit_rows_folded").inc(rows)
        return rows

    def _skip(self, fname: str, err: Exception, reg) -> int:
        """Durably skip one bad chunk, loudly (a counter and an event)."""
        reg.counter("refit_chunks_skipped").inc()
        self._emit("chunk_skipped", chunk=fname, error=f"{type(err).__name__}: {str(err)[:200]}")
        logger.warning("refit: skipping bad chunk %s (%r)", fname, err)
        self.processed.add(fname)
        return 0

    # ---------------------------------------------------------- publish

    def _widths(self):
        return self.fs.widths or (self._plan.fit.widths if self._plan else None)

    def _save_state(self) -> None:
        """Persist the state and offsets durably (the at-least-once ack;
        alone when a cycle only SKIPPED chunks: the skip must stick without
        a new model version)."""
        meta = dict(self.fs.meta)
        meta.update(processed=sorted(self.processed), version=self.version,
                    rows=self.rows_total)
        save_fit_state(self.state, self.state_path, est=self.fs.est, prefix=self.fs.prefix,
                       widths=self._widths(), **meta)
        self.fs.meta = meta

    def publish(self) -> str:
        """Re-finalize off the accumulated state and publish: the versioned
        model file, the ``current.kst`` pointer, then the durable state
        with the new offsets — in that order, so a crash between steps
        republishes rather than losing data. Times each part into
        :attr:`last_publish`."""
        from keystone_tpu_torch.core.pipeline import Pipeline
        from keystone_tpu_torch.core.serialization import atomic_write, save_fitted

        t0 = time.perf_counter()
        model = self.fs.est.fit_stats_finalize(self.state, widths=self._widths())
        synchronize(self.device)
        t_final = time.perf_counter()
        pipe = Pipeline.of(*self.fs.prefix, model)
        self.version += 1
        vname = f"model_v{self.version:06d}.kst"
        vpath = os.path.join(self.out_dir, vname)
        save_fitted(pipe, vpath, version=self.version, rows=self.rows_total, refit=True,
                    sample=self.fs.meta.get("sample"))
        # the pointer: a byte copy then os.replace, so a reader holding
        # current.kst open mid-swap still reads one complete artifact
        current = os.path.join(self.out_dir, CURRENT_MODEL)
        with open(vpath, "rb") as src, atomic_write(current) as dst:
            shutil.copyfileobj(src, dst)
        t_model = time.perf_counter()
        self._save_state()
        t_state = time.perf_counter()
        wall = t_state - t0
        self.last_publish = {
            "finalize_s": t_final - t0,
            "model_write_s": t_model - t_final,
            "state_write_s": t_state - t_model,
            "state_bytes": os.path.getsize(self.state_path),
            "wall_s": wall,
        }
        _metrics.get_registry().counter("refit_publishes").inc()
        self._emit("publish", version=self.version, model=vname, rows_total=self.rows_total,
                   wall_s=round(wall, 3))
        logger.info("refit: published %s (v%d, %d rows total) in %.2fs",
                    vpath, self.version, self.rows_total, wall)
        self._notify(current)
        return vpath

    def _notify(self, model_path: str) -> None:
        """Best-effort POST /admin/reload at the configured server; a server
        that is down picks the new ``current.kst`` up at its next reload."""
        if not self.notify_url:
            return
        import urllib.request

        url = self.notify_url.rstrip("/") + "/admin/reload"
        body = json.dumps({"path": os.path.abspath(model_path)}).encode()
        try:
            req = urllib.request.Request(url, data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60.0) as r:
                payload = json.loads(r.read())
            logger.info("refit: server reloaded: %s", payload)
        except Exception as e:  # noqa: BLE001 — the push is best-effort
            _metrics.get_registry().counter("refit_notify_failed").inc()
            self._emit("notify_failed", url=url, error=f"{type(e).__name__}: {str(e)[:200]}")
            logger.warning("refit: reload notify failed: %r", e)

    def _emit(self, action: str, **fields: Any) -> None:
        log = _events.active()
        if log is not None:
            log.emit("refit", action=action, **fields)

    # -------------------------------------------------------------- run

    def run_once(self) -> dict:
        """One scan-fold-publish cycle; returns a summary (no publish when
        nothing new arrived)."""
        folded = skipped = rows = 0
        for fname in self.pending():
            if self._stop.is_set():
                break
            n = self.fold(fname)
            if n:
                folded += 1
                rows += n
            else:
                skipped += 1
        out = {"chunks_folded": folded, "chunks_skipped": skipped, "rows": rows,
               "version": self.version}
        if folded:
            out["model"] = self.publish()
            out["version"] = self.version
        elif skipped:
            # nothing folded: persist the skip offsets only, no new version
            self._save_state()
        return out

    def run(self, interval_s: float = 2.0) -> None:
        """Poll until stopped (SIGTERM/SIGINT set the stop event; the cycle
        in flight completes)."""
        while not self._stop.is_set():
            summary = self.run_once()
            if summary.get("model"):
                print(f"refit: v{summary['version']} ({summary['chunks_folded']} chunk(s), "
                      f"{summary['rows']} row(s)) -> {summary['model']}", flush=True)
            self._stop.wait(interval_s)

    def stop(self) -> None:
        self._stop.set()


# --------------------------------------------------------------------- CLI


USAGE = """usage: python -m keystone_tpu_torch.learn.refit <state> --watch DIR [options]
<state>: a save_fit_state artifact (digest-checked on load)
options:
  --watch DIR     labeled-chunk directory to tail (*.npz with data/labels)
  --out DIR       published-model directory (default: the state file's dir)
  --once          one scan-fold-publish cycle, then exit
  --interval S    poll interval in seconds (default 2)
  --notify URL    POST /admin/reload at this server after each publish
  --device D      where to fold (default: the card; cpu for tests)
"""


def _parse(argv: list[str]) -> tuple[str, dict]:
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit(USAGE)
    state, args, i = argv[0], {}, 1
    valued = {"--watch": "watch", "--out": "out", "--interval": "interval",
              "--notify": "notify", "--device": "device"}
    while i < len(argv):
        a = argv[i]
        if a == "--once":
            args["once"] = True
            i += 1
        elif a in valued:
            if i + 1 >= len(argv):
                raise SystemExit(f"{a} needs a value")
            args[valued[a]] = argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"unknown option {a!r}\n{USAGE}")
    if "watch" not in args:
        raise SystemExit(f"--watch DIR is required\n{USAGE}")
    return state, args


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    state_path, args = _parse(argv)
    try:
        daemon = RefitDaemon(state_path, args["watch"], out_dir=args.get("out"),
                             notify_url=args.get("notify"), device=args.get("device"))
    except FitStateError as e:
        raise SystemExit(f"refit: {e}")
    if args.get("once"):
        print(json.dumps(daemon.run_once()), flush=True)
        return
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: daemon.stop())
    daemon.run(interval_s=float(args.get("interval", 2.0)))


if __name__ == "__main__":
    main()
