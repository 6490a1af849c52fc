"""Shadow A/B promotion: score the candidate on live traffic first — port
of ``keystone_tpu/learn/shadow.py``.

The incumbent keeps answering every request while the candidate re-scores
a sample of the SAME rows on a thread of its own:

- per-request **divergence** between the two outputs lands in a
  ``shadow.compare`` span (when a span sink is active) and in
  ``serve_shadow_*`` metrics: the argmax-mismatch rate for class scores,
  the mismatch rate for integer predictions, the normalized mean-abs
  difference otherwise;
- **feature drift** of the incoming rows against the fit state's
  accumulated means and variances feeds
  :meth:`keystone_tpu_torch.observe.health.HealthMonitor.note_feature_drift`;
- **promotion is gated**: :meth:`ShadowRunner.verdict` promotes only after
  ``min_samples`` scored requests with mean divergence under the threshold
  and no drift hit since the shadow started. A failed gate keeps the
  incumbent serving.

Scoring rides a bounded queue: shadow work adds no latency to the primary
path, and overload drops samples (counted) instead of backing requests up.
On the card the candidate replays its own CUDA graphs, under its own
replay lock.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any

import numpy as np

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.observe import health as _health
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.observe import spans as _spans

logger = get_logger("keystone_tpu_torch.learn.shadow")


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def divergence(primary: Any, candidate: Any) -> float:
    """One disagreement score in [0, 1]-ish between two outputs on the same
    rows: the mismatch rate for integer predictions, the argmax-mismatch
    rate for (n, k) score matrices, the normalized mean-abs difference
    otherwise; a shape disagreement scores 1.0."""
    p, c = _np(primary), _np(candidate)
    if p.shape != c.shape:
        return 1.0
    if p.size == 0:
        return 0.0
    if np.issubdtype(p.dtype, np.integer):
        return float(np.mean(p != c))
    if p.ndim >= 2 and p.shape[-1] > 1:
        return float(np.mean(np.argmax(p, -1) != np.argmax(c, -1)))
    denom = float(np.mean(np.abs(p))) + 1e-12
    return float(np.mean(np.abs(p - c)) / denom)


def input_feature_stats(fit_state: Any) -> tuple | None:
    """(mean, variance) of the corpus a state accumulated, in INPUT space
    — the only space raw request rows can be compared in — so None when
    the state folds a featurize prefix other than identities."""
    from keystone_tpu_torch.core.pipeline import Identity
    from keystone_tpu_torch.ops.linear import NormalEqState
    from keystone_tpu_torch.ops.weighted_linear import WeightedEqState

    prefix = tuple(getattr(fit_state, "prefix", ()) or ())
    if any(not isinstance(p, Identity) for p in prefix):
        return None
    s = fit_state.state
    if isinstance(s, NormalEqState):
        n = max(float(s.n), 1.0)
        return _np(s.mean_a), np.diag(_np(s.ata)) / n
    if isinstance(s, WeightedEqState):
        n = max(float(s.n), 1.0)
        mean = _np(s.sum_a) / n
        return mean, np.diag(_np(s.ata)) / n - mean**2
    return None


class ShadowRunner:
    """Scores an exported candidate on sampled primary requests.

    ``sample_every=k`` scores every k-th request (deterministic);
    ``feature_stats`` is an optional input-space ``(mean, variance)`` for
    the drift gate. :meth:`observe` is called by the serve path after the
    primary result resolved; it only queues references."""

    def __init__(
        self,
        exported: Any,
        version: str,
        *,
        sample_every: int = 1,
        divergence_threshold: float = 0.02,
        min_samples: int = 20,
        feature_stats: tuple | None = None,
        max_queue: int = 64,
    ):
        self.exported = exported
        self.version = version
        self.sample_every = max(int(sample_every), 1)
        self.divergence_threshold = float(divergence_threshold)
        self.min_samples = int(min_samples)
        self.feature_stats = feature_stats
        self._seen = itertools.count()
        self._queue: collections.deque = collections.deque()
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._stop = False
        self._busy = False  # the worker is mid-score (guarded by _cond)
        self._lock = threading.Lock()
        self._samples = 0
        self._div_sum = 0.0
        self._div_max = 0.0
        # the gate counts its OWN drift hits: the health monitor's alert is
        # cooldown-limited and must not hide live drift from a gate
        self._drift_hits = 0
        self._worker = threading.Thread(target=self._run, name="serve-shadow", daemon=True)
        self._worker.start()

    def observe(self, rows: Any, primary_out: Any, rid: Any = None) -> None:
        """Maybe queue one (rows, primary result) pair for scoring. Never
        blocks: a full queue drops the sample (counted)."""
        if next(self._seen) % self.sample_every:
            return
        with self._cond:
            if self._stop:
                return
            if len(self._queue) >= self.max_queue:
                _metrics.get_registry().counter("serve_shadow_dropped").inc()
                return
            self._queue.append((rows, primary_out, rid))
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.5)
                if self._stop and not self._queue:
                    return
                rows, primary, rid = self._queue.popleft()
                self._busy = True
            try:
                self._score(rows, primary, rid)
            except Exception as e:  # noqa: BLE001 — the shadow must not die
                _metrics.get_registry().counter("serve_shadow_errors").inc()
                logger.warning("shadow scoring failed: %r", e)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _score(self, rows: Any, primary: Any, rid: Any) -> None:
        reg = _metrics.get_registry()
        span_log = _spans.active_span_log()
        t0 = time.perf_counter()
        candidate = _np(self.exported(rows))
        wall = time.perf_counter() - t0
        div = divergence(primary, candidate)
        with self._lock:
            self._samples += 1
            self._div_sum += div
            self._div_max = max(self._div_max, div)
        reg.counter("serve_shadow_requests").inc()
        reg.timer("serve_shadow_seconds").observe(wall)
        reg.gauge("serve_shadow_divergence").set(div)
        if span_log is not None:
            span_log.record_span(
                "shadow.compare", wall_s=wall, rid=rid, divergence=round(div, 6),
                candidate_version=self.version, rows=int(np.asarray(rows).shape[0]),
            )
        if self.feature_stats is not None:
            mon = _health.get_monitor()
            mean, var = self.feature_stats
            sigma = np.sqrt(np.maximum(np.asarray(var), 1e-12))
            x = np.asarray(rows, np.float32)
            z = float(np.mean(np.abs(x.mean(axis=0) - np.asarray(mean)) / sigma))
            if z > mon.config.feature_drift_z:
                with self._lock:
                    self._drift_hits += 1
            mon.note_feature_drift(z, rid=rid)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until every queued and in-flight sample is scored."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._cond.wait(timeout=min(remaining, 0.1))

    def verdict(self) -> dict:
        """The gate's inputs and decision: promote only when enough
        requests scored, the mean divergence clears the threshold and no
        drift hit since the shadow started."""
        with self._lock:
            samples = self._samples
            mean_div = self._div_sum / samples if samples else 0.0
            max_div = self._div_max
            drift = self._drift_hits
        promote = (
            samples >= self.min_samples
            and mean_div <= self.divergence_threshold
            and drift == 0
        )
        return {
            "candidate_version": self.version,
            "samples": samples,
            "min_samples": self.min_samples,
            "mean_divergence": round(mean_div, 6),
            "max_divergence": round(max_div, 6),
            "divergence_threshold": self.divergence_threshold,
            "drift_alerts": drift,
            "promote": promote,
        }

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=10.0)
