"""Online autotuner: live goodput attribution drives knob retuning.

The port's copy of ``keystone_tpu/plan/tune.py``, its imports pointed at
``keystone_tpu_torch``. One addition: the stage-depth knob writes
``KEYSTONE_STAGE_DEPTH`` into the process environment, and :func:`reset`
puts the variable back as it was before the first write.

The observe stack measures *where the time goes* (the goodput
buckets: queue / wait_host / wait_device / compute); the planner chooses
chunk size, stage depth, and materialization *once* from static cost
profiles. This module is the feedback half of the loop — the tf.data
story (arxiv 2101.12127, dynamic prefetch/parallelism optimization from
runtime signals) applied to this codebase's knobs:

- the hot paths feed the active :class:`Autotuner` cheap observations
  (``observe(rows=…, buckets={"wait_host": dt, …})`` — the staging
  engine, the ingest frontier, and the LM train loop are wired),
- the tuner aggregates a rolling window (``KEYSTONE_TUNE_WINDOW_S`` on
  an injectable clock — every decision is a pure function of the fed
  observations, so the tests run with zero sleeps),
- at each window boundary it attributes the dominant stall and
  hill-climbs ONE knob:

  ===============  ======================================================
  ``wait_host``    more ingest parallelism (``ingest_workers`` ×2), else
                   deeper staging (``stage_depth`` +1)
  ``wait_device``  smaller chunks (``chunk_rows`` ÷2), else a smaller
                   micro-batch bucket
  ``queue``        widen the serve micro-batch bucket
  ===============  ======================================================

- the climb is guarded: per-knob cooldown, and every adjustment carries
  the pre-change window's goodput as its baseline — if the next window
  regresses past ``revert_tolerance`` the knob is walked back
  (``tune_reverts``); otherwise the change commits and, when a plan
  store is bound (:mod:`.store`, ``KEYSTONE_PLAN_STORE``), the learned
  (plan + knob) record is persisted so the next run starts tuned.

The controller is itself fully observable: every decision is one
declared ``tune`` event (action ``adjust`` / ``commit`` / ``revert`` /
``hold`` / ``load``, with the current knob snapshot) plus ``tune_*``
counters, and the current knob values are exported as Prometheus gauges
(``tune_stage_depth`` / ``tune_chunk_rows`` / ``tune_ingest_workers``)
so a ``/metrics`` scrape shows what the runtime converged to. The
``tune.bad_knob`` fault site forces a knob to its worst bound at the
keyed evaluation — the deterministic drill the revert guard must
survive.

Activation mirrors :mod:`keystone_tpu_torch.observe.events`: ``KEYSTONE_TUNE``
truthy builds the default tuner on first use; disabled paths pay one
global read (and the call sites gate even the import — see
:func:`keystone_tpu_torch.core.staging.tune_active`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Callable

ENV_TUNE = "KEYSTONE_TUNE"
ENV_WINDOW_S = "KEYSTONE_TUNE_WINDOW_S"
ENV_COOLDOWN_S = "KEYSTONE_TUNE_COOLDOWN_S"
ENV_TOLERANCE = "KEYSTONE_TUNE_TOLERANCE"
ENV_INGEST_WORKERS = "KEYSTONE_INGEST_WORKERS"

#: stall bucket → ordered knob candidates (name, direction). The first
#: registered, in-bounds, off-cooldown candidate is the one adjusted.
STALL_ACTIONS: dict[str, tuple[tuple[str, int], ...]] = {
    "wait_host": (("ingest_workers", +1), ("stage_depth", +1)),
    "wait_device": (("chunk_rows", -1), ("micro_batch_bucket", -1)),
    "queue": (("serve_bucket", +1),),
}

# window summaries kept for bench / the e2e tests — bounded so a
# day-long run can't grow the host heap
_MAX_HISTORY = 256

# bind_store's "caller did not pass a record" sentinel (None is a valid
# record value meaning "store consulted, nothing there")
_UNSET_RECORD: Any = object()


def enabled() -> bool:
    """The ``KEYSTONE_TUNE`` gate (unset/0/false/off → no tuner)."""
    return os.environ.get(ENV_TUNE, "").strip().lower() not in (
        "",
        "0",
        "false",
        "off",
        "no",
    )


@dataclasses.dataclass
class TuneConfig:
    """Controller parameters; env overrides via the ``KEYSTONE_TUNE_*``
    knobs named above."""

    window_s: float = 2.0  # rolling attribution window
    cooldown_s: float = 4.0  # min seconds between adjustments of a knob
    revert_tolerance: float = 0.05  # goodput drop that triggers a revert
    min_share: float = 0.2  # stall share of window wall before acting
    min_rows: int = 1  # observations needed before a window is judged

    @classmethod
    def from_env(cls) -> "TuneConfig":
        cfg = cls()
        for field, env in (
            ("window_s", ENV_WINDOW_S),
            ("cooldown_s", ENV_COOLDOWN_S),
            ("revert_tolerance", ENV_TOLERANCE),
        ):
            raw = os.environ.get(env, "").strip()
            if raw:
                try:
                    setattr(cfg, field, float(raw))
                except ValueError:
                    pass
        if ENV_COOLDOWN_S not in os.environ:
            cfg.cooldown_s = 2.0 * cfg.window_s
        return cfg


@dataclasses.dataclass
class Knob:
    """One tunable: a current value behind get/set closures, bounds, and
    a step rule (multiplicative ``scale`` or additive ``step``)."""

    name: str
    get: Callable[[], int]
    set: Callable[[int], None]
    lo: int = 1
    hi: int = 16
    scale: int | None = 2  # ×scale up / ÷scale down; None → ±step
    step: int = 1

    def next_value(self, direction: int) -> int | None:
        """The hill-climb's next value in ``direction`` (+1 up / −1
        down), or None when already at the bound."""
        v = int(self.get())
        if direction > 0:
            nxt = min(self.hi, v * self.scale if self.scale else v + self.step)
        else:
            nxt = max(self.lo, v // self.scale if self.scale else v - self.step)
        return None if nxt == v else nxt


def value_knob(name: str, initial: int, **kw: Any) -> Knob:
    """A knob whose value lives in the knob itself (the ingest-worker
    and test knobs) — consumers read it via :meth:`Autotuner.value`."""
    box = {"v": int(initial)}
    return Knob(
        name,
        get=lambda: box["v"],
        set=lambda v: box.__setitem__("v", int(v)),
        **kw,
    )


def _stage_depth_knob() -> Knob:
    """The live ``KEYSTONE_STAGE_DEPTH`` knob: every new staged stream
    reads the env (:func:`keystone_tpu_torch.core.staging.default_stage_depth`),
    so setting it retunes staging mid-run without touching call sites."""
    from keystone_tpu_torch.core.staging import ENV_STAGE_DEPTH, default_stage_depth

    def set_depth(v: int) -> None:
        with _state_lock:
            if ENV_STAGE_DEPTH not in _env_saved:
                _env_saved[ENV_STAGE_DEPTH] = os.environ.get(ENV_STAGE_DEPTH)
        os.environ[ENV_STAGE_DEPTH] = str(int(v))

    return Knob(
        "stage_depth",
        get=default_stage_depth,
        set=set_depth,
        lo=1,
        hi=8,
        scale=None,
        step=1,
    )


def _default_ingest_initial() -> int:
    raw = os.environ.get(ENV_INGEST_WORKERS, "").strip()
    if raw:
        try:
            return max(int(raw), 1)
        except ValueError:
            pass
    # start conservative and let wait_host attribution grow it — the
    # tf.data posture (the UNtuned default is wider; see
    # loaders/streaming.default_ingest_workers)
    return 2


class Autotuner:
    """The online controller. Thread-safe; all decisions derive from fed
    observations plus the injected ``clock``, so drills and tests replay
    exactly."""

    def __init__(
        self,
        config: TuneConfig | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or TuneConfig.from_env()
        self.clock = clock
        self.knobs: dict[str, Knob] = {}
        self.history: deque = deque(maxlen=_MAX_HISTORY)
        self._lock = threading.RLock()
        self._win_buckets: dict[str, float] = {}
        self._win_rows = 0
        self._win_start = clock()
        self._pending: dict | None = None  # the adjustment under judgment
        self._last: dict | None = None
        self._evals = 0
        self._cooldown_until: dict[str, float] = {}
        self._revert_streak: dict[str, int] = {}  # consecutive reverts
        self._store: tuple[str, str | None, dict] | None = None
        self._store_loaded = False
        self._chunk_fp: str | None = None  # pipeline owning chunk_rows

    # ---------------------------------------------------------- knobs

    def register(self, knob: Knob) -> Knob:
        with self._lock:
            self.knobs[knob.name] = knob
        self._gauge(knob.name, knob.get())
        return knob

    def value(self, name: str) -> int | None:
        """Current value of a registered knob, or None — the read the
        consumers poll (the ingest frontier each refill, the planner per
        plan)."""
        knob = self.knobs.get(name)
        return None if knob is None else int(knob.get())

    def bind_chunk(self, size: int, fingerprint: str | None = None) -> None:
        """Register the planner's chunk size as the ``chunk_rows`` knob,
        seeded from the planned value (×2 steps keep powers of two
        landing on the same compiled executables). The knob is scoped to
        ``fingerprint``: a DIFFERENT pipeline planning in the same
        process re-seeds it from its own plan instead of inheriting a
        chunk tuned for someone else's working set."""
        with self._lock:
            if not size:
                return
            if "chunk_rows" in self.knobs and fingerprint == self._chunk_fp:
                return
            size = int(size)
            self._chunk_fp = fingerprint
            self.register(
                value_knob(
                    "chunk_rows",
                    size,
                    lo=max(size // 16, 1),
                    hi=size * 16,
                    scale=2,
                )
            )

    def chunk_value_for(self, fingerprint: str | None) -> int | None:
        """The live ``chunk_rows`` value, but ONLY for the pipeline that
        bound it — another pipeline must not inherit a chunk sized for
        a different working set."""
        with self._lock:
            if fingerprint != self._chunk_fp:
                return None
        return self.value("chunk_rows")

    def _gauge(self, name: str, value: Any) -> None:
        from keystone_tpu_torch.observe import metrics as _metrics

        try:
            _metrics.get_registry().gauge(f"tune_{name}").set(float(value))
        except Exception:  # noqa: BLE001 — observability must degrade
            pass

    # ----------------------------------------------------- plan store

    def bind_store(
        self,
        fingerprint: str,
        device_kind: str | None,
        plan_info: dict,
        *,
        base: str | None = None,
        record: Any = _UNSET_RECORD,
    ) -> None:
        """Attach the (pipeline fingerprint, device kind) identity the
        learned record persists under, and — once — apply a previously
        stored record's knob values as this run's starting point.
        ``record`` lets a caller that already consulted the store (the
        planner) pass the loaded payload (or None) instead of paying a
        second load — and a second ``plan_store_hits`` bump."""
        from keystone_tpu_torch.plan import store as _store

        with self._lock:
            self._store = (fingerprint, device_kind, dict(plan_info))
            if self._store_loaded:
                return
            self._store_loaded = True
        if record is _UNSET_RECORD:
            try:
                record = _store.load(
                    fingerprint, device_kind=device_kind, base=base
                )
            except _store.PlanStoreError:
                return  # the loader already counted/warned; start untuned
        rec = record
        if not rec:
            return
        applied = {}
        with self._lock:
            for name, value in (rec.get("knobs") or {}).items():
                knob = self.knobs.get(name)
                if knob is None or value is None:
                    continue
                v = max(knob.lo, min(knob.hi, int(value)))
                knob.set(v)
                applied[name] = v
        for name, v in applied.items():
            self._gauge(name, v)
        if applied:
            self._emit(
                "load",
                knob=None,
                detail={
                    "applied": applied,
                    "fingerprint": fingerprint,
                    "saved_ts": rec.get("saved_ts"),
                },
                counter="tune_loads",
            )

    def _save_learned(self, goodput: float) -> None:
        if self._store is None:
            return
        from keystone_tpu_torch.observe import events as _events
        from keystone_tpu_torch.plan import store as _store

        fingerprint, device_kind, plan_info = self._store
        log = _events.active()
        # the saved plan carries the TUNED values, not what the planner
        # chose at bind time — the next run must start where this one
        # converged, and the chunk/depth knobs may have moved since
        plan_info = dict(plan_info)
        if "chunk_rows" in self.knobs:
            plan_info["chunk_size"] = int(self.knobs["chunk_rows"].get())
        if "stage_depth" in self.knobs:
            plan_info["stage_depth"] = int(self.knobs["stage_depth"].get())
        try:
            _store.save(
                fingerprint,
                {
                    "knobs": {k: int(v.get()) for k, v in self.knobs.items()},
                    "plan": plan_info,
                    "provenance": {
                        "run": log.run_id if log is not None else None,
                        "goodput": round(goodput, 4),
                        "evals": self._evals,
                    },
                },
                device_kind=device_kind,
            )
        except OSError:
            from keystone_tpu_torch.core.logging import get_logger

            get_logger("keystone_tpu_torch.plan").warning(
                "plan-store save failed for %s; learned knobs not "
                "persisted",
                fingerprint,
            )

    def flush(self) -> None:
        """Force-persist the current knob settings (run teardown)."""
        with self._lock:
            last = self.history[-1] if self.history else {}
        self._save_learned(float(last.get("goodput") or 0.0))

    # ---------------------------------------------------- observations

    def observe(
        self,
        *,
        bucket: str | None = None,
        wall_s: float = 0.0,
        rows: int = 0,
        buckets: dict[str, float] | None = None,
    ) -> None:
        """Feed one observation: ``rows`` of completed work and/or
        classified stall wall(s). Cheap (one lock); window evaluation
        happens inline when the clock says the window elapsed."""
        with self._lock:
            if bucket is not None and wall_s > 0:
                self._win_buckets[bucket] = (
                    self._win_buckets.get(bucket, 0.0) + float(wall_s)
                )
            if buckets:
                for b, w in buckets.items():
                    if w and w > 0:
                        self._win_buckets[b] = (
                            self._win_buckets.get(b, 0.0) + float(w)
                        )
            if rows:
                self._win_rows += int(rows)
            now = self.clock()
            if now - self._win_start >= self.config.window_s:
                self._evaluate(now)

    def tick(self, force: bool = False) -> None:
        """Evaluate the current window if it elapsed (``force`` skips the
        clock check) — for consumers whose observation cadence is slower
        than the window."""
        with self._lock:
            now = self.clock()
            if force or now - self._win_start >= self.config.window_s:
                self._evaluate(now)

    # ------------------------------------------------------ controller

    def _evaluate(self, now: float) -> None:
        """One window verdict (lock held): judge the pending adjustment,
        then attribute the dominant stall and climb. Resets the window."""
        c = self.config
        elapsed = max(now - self._win_start, 1e-9)
        rows = self._win_rows
        walls = dict(self._win_buckets)
        self._win_buckets = {}
        self._win_rows = 0
        self._win_start = now
        if rows < c.min_rows:
            # nothing ran — slide the window and judge nothing (a
            # pending adjustment stays pending: an idle window is not
            # evidence of regression)
            return
        goodput = rows / elapsed
        # shares against the window's WALL-CLOCK, not the classified sum:
        # "wait_host is 80% of observed stalls" means nothing when stalls
        # are 1% of the window — the control signal is how much of real
        # time the stall ate (overlapping producer threads cap at 1.0)
        shares = {
            b: min(w / elapsed, 1.0) for b, w in sorted(walls.items())
        }
        summary: dict[str, Any] = {
            "goodput": round(goodput, 4),
            "rows": rows,
            "elapsed_s": round(elapsed, 4),
            "shares": {b: round(s, 4) for b, s in shares.items()},
        }

        if self._pending is not None:
            self._judge_pending(goodput, summary, now)
        elif self._bad_knob_drill(goodput, now, summary):
            pass
        else:
            self._climb(goodput, shares, summary, now)
        self._evals += 1
        summary["eval"] = self._evals
        self.history.append(summary)

    def _judge_pending(
        self, goodput: float, summary: dict, now: float
    ) -> None:
        p, self._pending = self._pending, None
        knob = self.knobs.get(p["knob"])
        regressed = (
            p["baseline"] > 0
            and goodput < p["baseline"] * (1.0 - self.config.revert_tolerance)
        )
        if regressed and knob is not None:
            knob.set(p["old"])
            self._gauge(knob.name, p["old"])
            # exponential backoff on a knob that keeps regressing: the
            # plain cooldown alone would re-apply the same failed move
            # every expiry — an adjust/revert oscillation that leaves
            # every third window running detuned
            streak = self._revert_streak.get(p["knob"], 0) + 1
            self._revert_streak[p["knob"]] = streak
            self._cooldown_until[p["knob"]] = now + self.config.cooldown_s * (
                2 ** min(streak, 6)
            )
            summary.update(action="revert", knob=p["knob"])
            self._emit(
                "revert",
                knob=p["knob"],
                detail={
                    "from": p["new"],
                    "to": p["old"],
                    "goodput": round(goodput, 4),
                    "baseline": round(p["baseline"], 4),
                    "backoff": streak,
                },
                counter="tune_reverts",
                counter_labels={"knob": p["knob"]},
            )
        else:
            self._revert_streak.pop(p["knob"], None)
            summary.update(action="commit", knob=p["knob"])
            self._emit(
                "commit",
                knob=p["knob"],
                detail={
                    "value": p["new"],
                    "goodput": round(goodput, 4),
                    "baseline": round(p["baseline"], 4),
                },
                counter="tune_commits",
            )
            self._save_learned(goodput)

    def _bad_knob_drill(
        self, goodput: float, now: float, summary: dict
    ) -> bool:
        """The ``tune.bad_knob`` fault site: force a knob to its worst
        bound so the revert guard has something real to walk back."""
        from keystone_tpu_torch.resilience import faults as _faults

        if not self.knobs or not _faults.fire("tune.bad_knob", key=self._evals):
            return False
        name = sorted(self.knobs)[0]
        knob = self.knobs[name]
        old = int(knob.get())
        bad = knob.hi if old != knob.hi else knob.lo
        knob.set(bad)
        self._gauge(name, bad)
        self._pending = {"knob": name, "old": old, "new": bad, "baseline": goodput}
        self._cooldown_until[name] = now + self.config.cooldown_s
        summary.update(action="adjust", knob=name, injected=True)
        self._emit(
            "adjust",
            knob=name,
            detail={
                "from": old,
                "to": bad,
                "injected": "tune.bad_knob",
                "goodput": round(goodput, 4),
            },
            counter="tune_adjusts",
            counter_labels={"knob": name},
        )
        return True

    def _climb(
        self, goodput: float, shares: dict, summary: dict, now: float
    ) -> None:
        c = self.config
        stalls = {
            b: s for b, s in shares.items() if b in STALL_ACTIONS
        }
        dominant = max(stalls, key=stalls.get) if stalls else None
        if dominant is None or stalls[dominant] < c.min_share:
            summary.update(action="hold", reason="no_dominant_stall")
            self._emit(
                "hold",
                knob=None,
                detail={
                    "reason": "no_dominant_stall",
                    "goodput": round(goodput, 4),
                },
                counter="tune_holds",
            )
            return
        for name, direction in STALL_ACTIONS[dominant]:
            knob = self.knobs.get(name)
            if knob is None:
                continue
            if now < self._cooldown_until.get(name, 0.0):
                continue
            nxt = knob.next_value(direction)
            if nxt is None:
                continue
            old = int(knob.get())
            knob.set(nxt)
            self._gauge(name, nxt)
            self._pending = {
                "knob": name,
                "old": old,
                "new": nxt,
                "baseline": goodput,
            }
            self._cooldown_until[name] = now + c.cooldown_s
            summary.update(action="adjust", knob=name, stall=dominant)
            self._emit(
                "adjust",
                knob=name,
                detail={
                    "from": old,
                    "to": nxt,
                    "stall": dominant,
                    "share": round(stalls[dominant], 4),
                    "goodput": round(goodput, 4),
                },
                counter="tune_adjusts",
                counter_labels={"knob": name},
            )
            return
        summary.update(action="hold", reason="cooldown_or_bounds", stall=dominant)
        self._emit(
            "hold",
            knob=None,
            detail={
                "reason": "cooldown_or_bounds",
                "stall": dominant,
                "goodput": round(goodput, 4),
            },
            counter="tune_holds",
        )

    # ------------------------------------------------------ observability

    def _emit(
        self,
        action: str,
        *,
        knob: str | None,
        detail: dict,
        counter: str,
        counter_labels: dict | None = None,
    ) -> None:
        """Every decision: one declared ``tune`` event + ``tune_*``
        counters, with the full current knob snapshot riding along so
        ``observe top`` can render the converged values."""
        from keystone_tpu_torch.observe import events as _events
        from keystone_tpu_torch.observe import metrics as _metrics

        reg = _metrics.get_registry()
        reg.counter("tune_decisions").inc()
        reg.counter(counter, **(counter_labels or {})).inc()
        rec = {"action": action, **detail}
        if knob is not None:
            rec["knob"] = knob
        self._last = rec
        log = _events.active()
        if log is not None:
            log.emit(
                "tune",
                knobs={k: int(v.get()) for k, v in self.knobs.items()},
                **rec,
            )

    @classmethod
    def from_env(cls) -> "Autotuner":
        """The default env-activated tuner: the live staging-depth knob
        plus the ingest-worker pool size (chunk_rows joins when a plan
        binds one)."""
        import atexit

        t = cls(TuneConfig.from_env())
        t.register(_stage_depth_knob())
        t.register(
            value_knob(
                "ingest_workers",
                _default_ingest_initial(),
                lo=1,
                hi=16,
                scale=2,
            )
        )

        # run teardown: knobs still pending (or moved since the last
        # commit) must not be lost — the whole point of the store is
        # that the next run starts where this one ended
        def _flush_at_exit() -> None:
            try:
                t.flush()
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass

        atexit.register(_flush_at_exit)
        return t


# ------------------------------------------------------ module activation

_UNINIT: Any = object()
_active: Any = _UNINIT
_state_lock = threading.Lock()
# env variables a knob wrote, with the value each held before the first
# write (None: unset) — reset() puts them back
_env_saved: dict[str, str | None] = {}


def active() -> Autotuner | None:
    """The process-wide tuner, or None. Env-gated lazy build; a tuner
    installed via :func:`configure` wins regardless of the env."""
    global _active
    t = _active
    if t is _UNINIT:
        with _state_lock:
            if _active is _UNINIT:
                _active = Autotuner.from_env() if enabled() else None
            t = _active
    return t


def configure(tuner: Autotuner | None) -> None:
    """Install a tuner programmatically (tests, bench); None disables."""
    global _active
    with _state_lock:
        _active = tuner


def reset() -> None:
    """Drop the tuner, put back every env variable a knob wrote, and
    re-arm env detection."""
    global _active
    with _state_lock:
        _active = _UNINIT
        for var, value in _env_saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value
        _env_saved.clear()
