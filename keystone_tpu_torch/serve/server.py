"""The serving front end: stdlib HTTP/JSON over the exported apply —
port of ``keystone_tpu/serve/server.py``.

``python -m keystone_tpu_torch.serve.server <model> [--port N]`` where
``<model>`` is:

- a ``save_fitted`` checkpoint path (what the refit daemon publishes),
- ``mnist`` — fit the synthetic MNIST random-FFT pipeline in process and
  serve it (``POST /predict``; no data files needed),
- ``lm`` — a transformer LM with random weights served through the
  continuous-batching decode pool (``POST /generate``).

It serves on the card; :func:`build_app` and :class:`ServeApp` take
``device="cpu"`` for tests.

Endpoints::

    POST /predict  {"rows": [[...], ...]}        -> {"predictions": [...]}
    POST /generate {"prompt": [...], "max_new"}  -> {"tokens": [...]}
    GET  /healthz                                -> status, model version, swaps
    GET  /metrics                                -> metrics registry snapshot
    POST /admin/reload {"path"?}                 -> hot swap (learn/swap.py)
    POST /admin/shadow {"path", ...}             -> start shadow scoring
    GET  /admin/shadow                           -> the shadow's verdict
    POST /admin/promote {"force"?}               -> gated promotion (409 refused)
    POST /admin/shadow/stop                      -> drop the candidate

SIGHUP reloads from the checkpoint the server was started on (the refit
daemon republishes it).

Wiring:

- requests coalesce in the :mod:`.queue` micro-batcher under
  ``KEYSTONE_SERVE_DEADLINE_MS`` and dispatch through the exported
  apply's bucket graphs,
- every request is keyed (a process-monotone id) through the
  ``serve.drop`` / ``serve.slow_request`` fault sites, so overload-shed
  and tail-latency behavior replay deterministically,
- a request-path :class:`~keystone_tpu_torch.resilience.watchdog.Watchdog`
  flags a wedged dispatch (in-flight work but no completions) with
  thread stacks,
- per-request latency lands in the ``serve_request_seconds`` /
  ``serve_http_seconds`` Timer reservoirs (p50/p95 in ``/healthz``),
  queue depth and batch fill in gauges, and lifecycle in ``serve``
  events when an observe sink is active,
- SIGTERM drains: stop accepting, finish what is queued, exit 0.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import health as _health
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.observe import spans as _spans
from keystone_tpu_torch.resilience import faults as _faults

logger = get_logger("keystone_tpu_torch.serve.server")

ENV_SLOW_MS = "KEYSTONE_SERVE_SLOW_MS"
ENV_TIMEOUT_S = "KEYSTONE_SERVE_TIMEOUT_S"

def _request_timeout_s() -> float:
    try:
        return float(os.environ.get(ENV_TIMEOUT_S, "") or 30.0)
    except ValueError:
        return 30.0


def _slow_s() -> float:
    try:
        return float(os.environ.get(ENV_SLOW_MS, "") or 100.0) / 1e3
    except ValueError:
        return 0.1


def _host(out) -> np.ndarray:
    """A served result as a host array."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


class ServeApp:
    """Everything behind the HTTP surface: the exported model, the
    micro-batcher / decode pool, fault-site admission, the request-path
    watchdog, and drain-on-shutdown. ``device`` (default: the card) is
    where the exported apply and the decode pool must live."""

    def __init__(
        self,
        *,
        exported=None,
        decode_loop=None,
        deadline_ms: float | None = None,
        watchdog_timeout_s: float = 60.0,
        model_version: str | None = None,
        device: torch.device | str | None = None,
    ):
        if exported is None and decode_loop is None:
            raise ValueError("need an exported pipeline and/or a decode loop")
        self.device = resolve_device(device)
        for what, served in (("exported apply", exported), ("decode pool", decode_loop)):
            if served is not None and served.device.type != self.device.type:
                raise ValueError(
                    f"the {what} is on {served.device}, the app on {self.device}"
                )
        self.exported = exported
        self.loop = decode_loop
        self._rid = itertools.count()
        self._inflight = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # the online-learning surface: the served model's version, the
        # hot swaps this process has taken, the swapper that performs them
        # (attached by build_app for reloadable models) and an optional
        # shadow scorer. _model_lock serializes batcher SUBMITS against
        # batcher REPLACEMENT: a request never reaches a closing batcher
        self.model_version = model_version
        self.swap_count = 0
        self._model_lock = threading.Lock()
        self._deadline_ms = deadline_ms
        self.swapper = None
        self.shadow = None
        self.batcher = None
        if exported is not None:
            from keystone_tpu_torch.serve.queue import MicroBatcher

            self.batcher = MicroBatcher(
                exported,
                buckets=exported.buckets,
                deadline_ms=deadline_ms,
            )
        self._decode_thread = None
        if decode_loop is not None:
            self._decode_thread = threading.Thread(
                target=decode_loop.worker,
                args=(self._stop,),
                name="serve-decode",
                daemon=True,
            )
            self._decode_thread.start()
        # request-path stall detection: in-flight work with no
        # completions for watchdog_timeout_s dumps stacks (log-only —
        # shedding/aborting is the operator's call, not the dog's)
        from keystone_tpu_torch.resilience.watchdog import Watchdog

        self._dog = Watchdog(
            timeout_s=watchdog_timeout_s, label="serve_dispatch"
        ).start()
        self._pet_thread = threading.Thread(
            target=self._pet_when_idle, name="serve-watchdog-pet", daemon=True
        )
        self._pet_thread.start()

    # --------------------------------------------------------- admission

    def admit(self) -> int:
        """Assign the request id and run the fault sites: a ``serve.drop``
        hit sheds the request (the caller 503s), a ``serve.slow_request``
        hit injects tail latency — both keyed by the id, so a drill
        replays exactly."""
        rid = next(self._rid)
        if _faults.fire("serve.drop", rid):
            _metrics.get_registry().counter("serve_shed").inc()
            raise OverloadShed(f"request {rid} shed (serve.drop)")
        if _faults.fire("serve.slow_request", rid):
            _metrics.get_registry().counter("serve_slowed").inc()
            time.sleep(_slow_s())
        return rid

    def _pet_when_idle(self) -> None:
        while not self._stop.wait(self._dog.poll_s):
            with self._lock:
                idle = self._inflight == 0
            if idle:
                self._dog.pet()
        self._dog.stop()

    def _bracket(self):
        app = self

        class _B:
            def __enter__(self):
                with app._lock:
                    app._inflight += 1
                return self

            def __exit__(self, *exc):
                with app._lock:
                    app._inflight -= 1
                app._dog.pet()
                return False

        return _B()

    # ----------------------------------------------------------- request

    def predict(self, rows, parent=None) -> np.ndarray:
        if self.batcher is None:
            raise ValueError("no pipeline exported on this server")
        t0 = time.perf_counter()
        try:
            rid = self.admit()
        except OverloadShed:
            _health.get_monitor().note_request(
                time.perf_counter() - t0, shed=True
            )
            raise
        # the request's root span: queue-wait / dispatch / device spans
        # recorded by the batcher (its thread) parent on this context.
        # ``parent`` adopts an upstream hop's (trace, span)
        span_kw = {} if parent is None else {"parent": parent}
        try:
            with self._bracket(), _spans.span(
                "serve.request", rid=rid, kind="predict", **span_kw
            ):
                # submit under the model lock: a hot swap replaces the
                # batcher under the same lock, so this request lands on a
                # batcher that will be drained, never one mid-close
                with self._model_lock:
                    fut = self.batcher.submit(rows, rid=rid)
                out = _host(fut.result(timeout=_request_timeout_s()))
        finally:
            # finally, not on success only: a timed-out request is by
            # definition the slowest one — the monitor MUST see it
            _health.get_monitor().note_request(
                time.perf_counter() - t0, rid=rid
            )
        shadow = self.shadow
        if shadow is not None:
            # after the primary result resolved: the shadow only queues
            # references (never blocks)
            shadow.observe(rows, out, rid=rid)
        return out

    def generate(
        self, prompt, max_new: int | None = None, parent=None
    ) -> np.ndarray:
        if self.loop is None:
            raise ValueError("no LM decode pool on this server")
        t0 = time.perf_counter()
        try:
            rid = self.admit()
        except OverloadShed:
            _health.get_monitor().note_request(
                time.perf_counter() - t0, shed=True
            )
            raise
        span_kw = {} if parent is None else {"parent": parent}
        try:
            with self._bracket(), _spans.span(
                "serve.request", rid=rid, kind="generate", **span_kw
            ):
                fut = self.loop.submit(prompt, max_new=max_new, rid=rid)
                out = np.asarray(fut.result(timeout=_request_timeout_s()))
        finally:
            _health.get_monitor().note_request(
                time.perf_counter() - t0, rid=rid
            )
        return out

    # ------------------------------------------------------------- swap

    def swap_exported(self, exported, version: str | None = None) -> None:
        """Atomically replace the served pipeline: a NEW micro-batcher on
        the candidate goes live under the model lock (no submit can
        interleave), then the OLD batcher drains — every request already
        queued finishes on the model it was admitted under; then the old
        model's graphs are released here, on the swapper's thread, where no
        capture runs. The caller (:class:`keystone_tpu_torch.learn.swap.
        ModelSwapper`) owns the load, spec check and probe in front of
        this, under its lock."""
        from keystone_tpu_torch.serve.queue import MicroBatcher

        if exported.device.type != self.device.type:
            raise ValueError(f"the candidate is on {exported.device}, the app on {self.device}")
        new_batcher = MicroBatcher(
            exported, buckets=exported.buckets, deadline_ms=self._deadline_ms
        )
        with self._model_lock:
            old_batcher, old_exported = self.batcher, self.exported
            self.batcher = new_batcher
            self.exported = exported
            self.model_version = version
            self.swap_count += 1
        if old_batcher is not None:
            old_batcher.close(drain=True)
        if old_exported is not None and old_exported is not exported:
            old_exported.release()

    def health(self) -> dict:
        reg = _metrics.get_registry()
        snap = reg.snapshot()
        t = snap.get("serve_request_seconds") or {}
        th = snap.get("serve_http_seconds") or {}
        out = {
            "status": "draining" if self._stop.is_set() else "ok",
            # set the MOMENT SIGTERM drain begins (before the batcher
            # drains, long before the socket closes) so an upstream
            # router stops sending work to a replica on its way out
            "draining": self._stop.is_set(),
            "requests": snap.get("serve_requests", 0)
            + snap.get("serve_decode_requests", 0),
            "batches": snap.get("serve_batches", 0),
            "shed": snap.get("serve_shed", 0),
            "queue_depth": snap.get("serve_queue_depth", 0.0),
            "batch_fill": snap.get("serve_batch_fill", 0.0),
            "slots_active": snap.get("serve_slots_active", 0.0),
        }
        if self.exported is not None:
            # which model version answers /predict now, and how many hot
            # swaps got it there
            out["model_version"] = self.model_version
            out["model_swaps"] = self.swap_count
        # where this process's run streams live, so a collector that
        # reached /healthz can tail the advertised dir
        log = _events.active()
        if log is not None and log.run_dir:
            out["run_dir"] = log.run_dir
        # local capture: a concurrent promote or stop can clear the attr
        shadow = self.shadow
        if shadow is not None:
            out["shadow"] = shadow.verdict()
        for name, summ in (("queue", t), ("http", th)):
            if summ.get("count"):
                out[f"{name}_p50_ms"] = round(summ.get("p50_s", 0.0) * 1e3, 3)
                out[f"{name}_p95_ms"] = round(summ.get("p95_s", 0.0) * 1e3, 3)
        return out

    # ----------------------------------------------------------- shadow

    def start_shadow(self, path: str, state_path: str | None = None, **kw) -> dict:
        """Load a candidate checkpoint (spec-checked), export it over the
        incumbent's buckets (on the card: capture its graphs) and start
        scoring sampled requests in shadow. ``kw`` goes to
        :class:`keystone_tpu_torch.learn.shadow.ShadowRunner`
        (sample_every, divergence_threshold, min_samples, feature_stats).
        ``state_path`` names the refit daemon's state: its means and
        variances arm the drift half of the gate when they are in input
        space."""
        if self.swapper is None:
            raise ValueError("no model swapper on this server")
        from keystone_tpu_torch.core.serialization import load_fitted
        from keystone_tpu_torch.learn.shadow import ShadowRunner, input_feature_stats
        from keystone_tpu_torch.learn.swap import version_of

        if state_path and "feature_stats" not in kw:
            from keystone_tpu_torch.learn.merge import load_fit_state

            kw["feature_stats"] = input_feature_stats(
                load_fit_state(state_path, device=self.device)
            )
        pipe, meta = load_fitted(path, with_meta=True, device=self.device)
        exported = self.swapper.export_candidate(pipe, meta)
        version = version_of(path, meta)
        old, self.shadow = self.shadow, ShadowRunner(exported, version, **kw)
        if old is not None:
            old.close()
            self.swapper.retire(old.exported)
        self.swapper._observe("shadow_start", candidate_version=version, path=path)
        return {"candidate_version": version, "shadowing": True}

    def promote_shadow(self, force: bool = False) -> dict:
        """Apply the gate to the shadow candidate: a promoted candidate is
        swapped in (its graphs are captured already); a refused one is
        DISCARDED and the last good primary keeps serving, loudly."""
        shadow = self.shadow
        if shadow is None:
            raise ValueError("no shadow candidate running")
        shadow.drain()
        verdict = shadow.verdict()
        if not verdict["promote"] and not force:
            self.shadow = None
            shadow.close()
            self.swapper.retire(shadow.exported)
            self.swapper._observe(
                "rollback",
                old_version=self.model_version,
                new_version=shadow.version,
                reason="shadow_gate",
                **{k: verdict[k] for k in ("samples", "mean_divergence", "drift_alerts")},
            )
            logger.warning(
                "shadow candidate %r rejected (divergence %.4f, %d drift alert(s)); still "
                "serving %r", shadow.version, verdict["mean_divergence"],
                verdict["drift_alerts"], self.model_version,
            )
            return {"promoted": False, **verdict}
        res = self.swapper.promote(shadow.exported, shadow.version)
        self.shadow = None
        shadow.close()
        return {"promoted": True, **verdict, **res}

    def stop_shadow(self) -> dict:
        shadow, self.shadow = self.shadow, None
        if shadow is None:
            return {"shadowing": False}
        verdict = shadow.verdict()
        shadow.close()
        self.swapper.retire(shadow.exported)
        self.swapper._observe("shadow_stop", candidate_version=shadow.version)
        return {"shadowing": False, **verdict}

    def shutdown(self) -> None:
        """Drain: no new work, finish queued work, stop the threads."""
        self._stop.set()
        if self.shadow is not None:
            self.shadow.close()
        if self.batcher is not None:
            self.batcher.close(drain=True)
        if self._decode_thread is not None:
            self._decode_thread.join(timeout=_request_timeout_s())
        log = _events.active()
        if log is not None:
            log.emit("serve", action="stop")


class OverloadShed(RuntimeError):
    """Admission refused this request (the 503 path). Carries
    ``retry_after_s`` so the HTTP surface can emit a Retry-After header
    — an upstream failover policy backs off by AT LEAST that much
    instead of re-stampeding the overload on its own schedule."""

    def __init__(self, msg: str, retry_after_s: int = 1):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


def write_metrics_response(handler) -> None:
    """The /metrics negotiation rule: Prometheus 0.0.4 text exposition by
    default (what a scraper expects), the JSON snapshot behind
    ``Accept: application/json``."""
    reg = _metrics.get_registry()
    accept = handler.headers.get("Accept") or ""
    if "application/json" in accept:
        body = json.dumps({"metrics": reg.snapshot()}).encode()
        ctype = "application/json"
    else:
        body = reg.to_prometheus().encode()
        ctype = "text/plain; version=0.0.4; charset=utf-8"
    handler.send_response(200)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _handler_for(app: ServeApp):
    class Handler(BaseHTTPRequestHandler):
        # suppress the default per-request stderr lines; metrics and the
        # event log are the record
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(
            self, code: int, payload: dict, headers: dict | None = None
        ) -> None:
            self._send_text(
                code, json.dumps(payload), "application/json", headers
            )

        def _send_text(
            self,
            code: int,
            text: str,
            content_type: str,
            headers: dict | None = None,
        ) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — stdlib API
            if self.path == "/healthz":
                return self._send(200, app.health())
            if self.path == "/admin/shadow":
                shadow = app.shadow  # local capture vs a concurrent stop
                if shadow is None:
                    return self._send(404, {"shadowing": False})
                return self._send(200, shadow.verdict())
            if self.path == "/metrics":
                return write_metrics_response(self)
            return self._send(
                404,
                {
                    "error": f"unknown path {self.path}",
                    "paths": [
                        "/predict", "/generate", "/healthz", "/metrics",
                        "/admin/reload", "/admin/shadow", "/admin/promote",
                    ],
                },
            )

        def do_POST(self):  # noqa: N802 — stdlib API
            t0 = time.perf_counter()
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                return self._send(400, {"error": "invalid JSON body"})
            if self.path.startswith("/admin/"):
                return self._admin(body)
            # adopt an upstream trace: "X-Keystone-Trace: <trace>:<span>"
            # parents the request's serve.request span
            parent = None
            raw_trace = self.headers.get("X-Keystone-Trace") or ""
            if ":" in raw_trace:
                t, _, s = raw_trace.partition(":")
                if t and s:
                    parent = _spans.SpanContext(t, s)
            try:
                if self.path == "/predict":
                    rows = np.asarray(body.get("rows"), np.float32)
                    out = app.predict(rows, parent=parent)
                    payload = {"predictions": out.tolist()}
                elif self.path == "/generate":
                    prompt = body.get("prompt")
                    out = app.generate(
                        prompt, max_new=body.get("max_new"), parent=parent
                    )
                    payload = {"tokens": out.tolist()}
                else:
                    return self._send(404, {"error": f"unknown path {self.path}"})
            except OverloadShed as e:
                return self._send(
                    503,
                    {"error": str(e)},
                    headers={"Retry-After": str(e.retry_after_s)},
                )
            except (ValueError, TypeError) as e:
                return self._send(400, {"error": str(e)})
            except TimeoutError as e:
                return self._send(504, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the server must answer
                logger.warning("request failed: %r", e)
                return self._send(500, {"error": repr(e)})
            wall = time.perf_counter() - t0
            _metrics.get_registry().timer("serve_http_seconds").observe(wall)
            payload["ms"] = round(wall * 1e3, 3)
            self._send(200, payload)

        def _admin(self, body: dict) -> None:
            """The online-learning control surface: reload (hot swap),
            shadow start, gated promote, shadow stop. Failures answer JSON
            with the still-serving version: a failed swap rolled back by
            construction."""
            from keystone_tpu_torch.learn.swap import SwapError

            try:
                if self.path == "/admin/reload":
                    if app.swapper is None:
                        return self._send(409, {"error": "no model swapper on this server"})
                    return self._send(200, app.swapper.swap_to_path(body.get("path")))
                if self.path == "/admin/shadow":
                    kw = {
                        k: body[k]
                        for k in ("state_path", "sample_every", "divergence_threshold",
                                  "min_samples")
                        if k in body
                    }
                    return self._send(200, app.start_shadow(body["path"], **kw))
                if self.path == "/admin/promote":
                    res = app.promote_shadow(force=bool(body.get("force")))
                    return self._send(200 if res.get("promoted") else 409, res)
                if self.path == "/admin/shadow/stop":
                    return self._send(200, app.stop_shadow())
                return self._send(404, {"error": f"unknown admin path {self.path}"})
            except SwapError as e:
                return self._send(
                    500, {"error": str(e), "rolled_back": True, "version": app.model_version}
                )
            except (KeyError, ValueError, TypeError) as e:
                return self._send(400, {"error": repr(e)})
            except Exception as e:  # noqa: BLE001 — the server must answer
                logger.warning("admin request failed: %r", e)
                return self._send(500, {"error": repr(e)})

    return Handler


# ------------------------------------------------------------------ models


def _fit_mnist_demo(n: int, num_ffts: int = 16, device=None):
    """Fit the MNIST random-FFT pipeline on synthetic data on ``device``
    — the in-process demo/smoke model (same construction as the real
    workload, scaled down). Returns (fitted pipeline, a 1-row sample)."""
    from keystone_tpu_torch.core.pipeline import Pipeline
    from keystone_tpu_torch.core.runtime import synchronize
    from keystone_tpu_torch.models.mnist_random_fft import (
        IMAGE_SIZE,
        NUM_CLASSES,
        FeaturizerBank,
        build_batch_featurizers,
        featurize,
    )
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
    centers = (
        np.random.default_rng(42)
        .normal(size=(NUM_CLASSES, IMAGE_SIZE))
        .astype(np.float32)
    )
    data = centers[labels] + rng.normal(size=(n, IMAGE_SIZE)).astype(
        np.float32
    )
    groups = build_batch_featurizers(num_ffts, 2048, seed=0, device=device)
    blocks = featurize(groups, torch.from_numpy(data).to(device))
    est = BlockLeastSquaresEstimator(block_size=2048, num_iter=1)
    model = est.fit(
        blocks, ClassLabelIndicators(num_classes=NUM_CLASSES)(labels).to(device)
    )
    del blocks
    bank = FeaturizerBank(batches=tuple(tuple(g) for g in groups))
    pipe = Pipeline.of(bank, model, MaxClassifier())
    pipe(torch.from_numpy(data[:1]).to(device))
    synchronize(device)
    return pipe, data[:1]


def _build_lm(args: dict, device=None):
    from keystone_tpu_torch.models.lm.model import TransformerLM

    device = resolve_device(device)
    return TransformerLM.create(
        vocab=int(args.get("vocab", 256)),
        max_seq=int(args.get("s_max", 256)),
        dim=int(args.get("dim", 64)),
        depth=int(args.get("depth", 2)),
        num_heads=int(args.get("heads", 4)),
        device=device,
        generator=torch.Generator(device=device).manual_seed(int(args.get("seed", 0))),
    )


# --------------------------------------------------------------------- CLI


USAGE = """usage: python -m keystone_tpu_torch.serve.server <model> [options]
<model>: a save_fitted checkpoint path | mnist | lm
options:
  --port N          listen port (default 8100; 0 = OS-assigned, printed)
  --host H          bind address (default 127.0.0.1)
  --buckets A,B,..  batch buckets (default KEYSTONE_SERVE_BUCKETS)
  --deadline-ms F   micro-batch SLO deadline (default KEYSTONE_SERVE_DEADLINE_MS)
  --synthetic N     mnist demo fit size (default 2048)
  --num-ffts N      mnist demo featurizer count (default 16)
  --slots N         lm decode slots (default 8)
  --max-new N       lm default tokens per request (default 64)
  --s-max N         lm pool sequence capacity (default 256)
  --quantize        lm weight-only int8
  --int8-kv         lm int8 KV cache
  --dim/--depth/--heads/--vocab/--seed  lm demo model shape
  --input-dim D     row width when serving a checkpoint with no sample meta
  --device D        where to serve (default: the card; cpu for tests)
"""


def _parse(argv: list[str]) -> tuple[str, dict]:
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit(USAGE)
    target, args, i = argv[0], {}, 1
    flags = {"--quantize": "quantize", "--int8-kv": "int8_kv"}
    valued = {
        "--port": "port", "--host": "host", "--buckets": "buckets",
        "--deadline-ms": "deadline_ms", "--synthetic": "synthetic",
        "--num-ffts": "num_ffts",
        "--slots": "slots", "--max-new": "max_new", "--s-max": "s_max",
        "--dim": "dim", "--depth": "depth", "--heads": "heads",
        "--vocab": "vocab", "--seed": "seed", "--input-dim": "input_dim",
        "--device": "device",
    }
    while i < len(argv):
        a = argv[i]
        if a in flags:
            args[flags[a]] = True
            i += 1
        elif a in valued:
            if i + 1 >= len(argv):
                raise SystemExit(f"{a} needs a value")
            args[valued[a]] = argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"unknown option {a!r}\n{USAGE}")
    return target, args


def build_app(target: str, args: dict, device: torch.device | str | None = None) -> ServeApp:
    """The app for ``target`` on ``device`` (default: the card). Its
    programs are captured here, before any serving thread starts."""
    from keystone_tpu_torch.learn.swap import ModelSwapper, version_of
    from keystone_tpu_torch.serve.export import export_lm, export_pipeline

    device = resolve_device(device)
    deadline = (
        float(args["deadline_ms"]) if "deadline_ms" in args else None
    )
    buckets = None
    if "buckets" in args:
        buckets = tuple(
            sorted(int(b) for b in str(args["buckets"]).split(",") if b)
        )
    if target in ("mnist", "mnist-random-fft"):
        pipe, sample = _fit_mnist_demo(
            int(args.get("synthetic", 2048)),
            num_ffts=int(args.get("num_ffts", 16)),
            device=device,
        )
        exported = export_pipeline(pipe, sample, buckets=buckets, device=device)
        app = ServeApp(
            exported=exported,
            deadline_ms=deadline,
            model_version="mnist-demo",
            device=device,
        )
        # reloadable with an explicit path (POST /admin/reload {"path"});
        # no default source: the demo fit has no file
        app.swapper = ModelSwapper(app)
        return app
    if target == "lm":
        model = _build_lm(args, device)
        loop = export_lm(
            model,
            slots=int(args.get("slots", 8)),
            s_max=int(args.get("s_max", 256)),
            quantize=bool(args.get("quantize")),
            int8_kv=bool(args.get("int8_kv")),
            max_new=int(args.get("max_new", 64)),
        )
        return ServeApp(decode_loop=loop, deadline_ms=deadline, device=device)
    if os.path.exists(target):
        from keystone_tpu_torch.core.serialization import load_fitted

        pipe, meta = load_fitted(target, with_meta=True, device=device)
        sample = meta.get("sample")
        if sample is None:
            if "input_dim" not in args:
                raise SystemExit(f"{target} carries no sample meta; pass --input-dim D")
            sample = np.zeros((1, int(args["input_dim"])), np.float32)
        exported = export_pipeline(pipe, np.asarray(sample), buckets=buckets, device=device)
        app = ServeApp(
            exported=exported,
            deadline_ms=deadline,
            model_version=version_of(target, meta),
            device=device,
        )
        # the reload source: POST /admin/reload without a path and SIGHUP
        # both read this file again — the refit daemon republishes it
        app.swapper = ModelSwapper(app, source_path=target)
        return app
    raise SystemExit(
        f"unknown model {target!r}: not a checkpoint path, 'mnist' or 'lm'"
    )


def install_reload_signal(app: ServeApp):
    """SIGHUP hot-reloads ``app`` from its swapper's source path (the
    refit daemon republishes it), off the signal frame, on a thread of its
    own; a failed swap keeps the prior version. Returns the previous
    handler. Call from the main thread."""

    def _hup(signum, frame):
        if app.swapper is None or not app.swapper.source_path:
            logger.warning("SIGHUP: no reloadable model path; ignored")
            return

        def reload():
            from keystone_tpu_torch.learn.swap import SwapError

            try:
                logger.info("SIGHUP reload: %s", app.swapper.swap_to_path())
            except SwapError as e:
                logger.warning("SIGHUP reload failed: %s", e)

        threading.Thread(target=reload, name="serve-sighup-reload", daemon=True).start()

    return signal.signal(signal.SIGHUP, _hup)


def main(argv: list[str] | None = None, device=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    target, args = _parse(argv)
    t0 = time.perf_counter()
    app = build_app(target, args, device=device if device is not None else args.get("device"))
    cold = time.perf_counter() - t0
    host = str(args.get("host", "127.0.0.1"))
    port = int(args.get("port", 8100))
    httpd = ThreadingHTTPServer((host, port), _handler_for(app))
    port = httpd.server_address[1]

    log = _events.active()
    if log is not None:
        log.emit(
            "serve", action="start", model=target, port=port,
            cold_start_s=round(cold, 3),
        )

    def _term(signum, frame):
        # drain from a helper thread: shutdown() must not run on the
        # serve_forever thread (it joins that loop). The stop flag flips
        # synchronously so /healthz reports draining from the very first
        # instant of the SIGTERM window.
        app._stop.set()
        logger.info("signal %d: draining and shutting down", signum)

        def stop():
            app.shutdown()
            httpd.shutdown()

        threading.Thread(target=stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    install_reload_signal(app)
    print(
        f"serving {target!r} on http://{host}:{port} "
        f"(cold start {cold:.2f}s)",
        flush=True,
    )
    try:
        httpd.serve_forever(poll_interval=0.1)
    finally:
        httpd.server_close()
    logger.info("server stopped cleanly")


if __name__ == "__main__":
    main()
