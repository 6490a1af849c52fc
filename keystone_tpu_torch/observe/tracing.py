"""Programmatic profiler trace windows for training loops — port of
``keystone_tpu/observe/tracing.py`` on ``torch.profiler``.

``core.profiling.trace`` brackets a whole code block; a multi-hour train
loop needs the opposite — profile *10 steps starting at step 120*
without restarting the run. Two triggers:

- ``KEYSTONE_PROFILE_STEPS="120:10"`` — capture 10 steps starting at
  step 120. Comma-separate multiple windows (``"120:10,5000:5"``).
- ``SIGUSR2`` — arm an on-demand window at the next step boundary
  (default :data:`DEFAULT_SIGNAL_STEPS` steps), for the "why is it slow
  *right now*" case.

Traces land in ``<base>/step_<start>/trace.json`` (a Chrome trace)
where ``<base>`` is, in order: an explicit ``log_dir``,
``KEYSTONE_TRACE_DIR``, or a ``traces/`` subdirectory of the active
observe run. The ``KEYSTONE_TRACE_DIR`` kill switch (``0``/``off``/empty
— see :mod:`keystone_tpu_torch.core.profiling`) disables every window.
All profiler failures degrade to one warning and an unprofiled run, as
``trace()`` does.

A profiler session over CUDA work can come back without device activity
(seen once over a CUDA-graph replay), or without some of its device
records (the first ones of a session, which ``core.profiling`` primes
for). A window in which the card recorded nothing, not even the primer,
is recorded as ``status="empty"``, and one whose trace lacks the device
record of a launch, copy or set past the primer as
``status="incomplete"`` with ``lost_device_events`` — never as a window
of fewer launches. ``device_events`` counts the device events of the
window's work. :attr:`StepTracer.windows` keeps each closed window's
record.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.core.profiling import (
    ENV_TRACE_DIR,
    TRACE_FILE,
    _DISABLED_VALUES,
    audit_trace,
    start_profiler,
    stop_profiler,
)
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics

logger = get_logger("keystone_tpu_torch.observe.tracing")

ENV_PROFILE_STEPS = "KEYSTONE_PROFILE_STEPS"
DEFAULT_SIGNAL_STEPS = 10


def parse_windows(spec: str) -> list[tuple[int, int]]:
    """Parse ``"start:steps[,start:steps...]"`` → ``[(start, steps)]``.

    Raises ``ValueError`` on malformed specs (non-integer, non-positive
    step count, negative start) so a typo is reported, not ignored."""
    out: list[tuple[int, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        head, sep, tail = part.partition(":")
        if not sep:
            raise ValueError(
                f"bad {ENV_PROFILE_STEPS} window {part!r}: expected "
                "'start:steps' (e.g. '120:10')"
            )
        try:
            start, steps = int(head), int(tail)
        except ValueError:
            raise ValueError(
                f"bad {ENV_PROFILE_STEPS} window {part!r}: start and "
                "steps must be integers"
            ) from None
        if start < 0 or steps <= 0:
            raise ValueError(
                f"bad {ENV_PROFILE_STEPS} window {part!r}: start must be "
                ">= 0 and steps > 0"
            )
        out.append((start, steps))
    return sorted(out)


class StepTracer:
    """Starts/stops ``torch.profiler`` traces around step windows.

    Call :meth:`step` with the upcoming step index at the TOP of every
    loop iteration — a window ``(s, n)`` then brackets the dispatch of
    steps ``[s, s+n)``. The idle cost per step is one flag check plus a
    scan of the (tiny) un-fired window list; with no windows configured
    and no signal installed, :meth:`from_env` returns None and the loop
    skips even that.
    """

    def __init__(
        self,
        windows: list[tuple[int, int]] | None = None,
        log_dir: str | None = None,
        signal_steps: int = DEFAULT_SIGNAL_STEPS,
        label: str = "train",
    ):
        self._windows = [
            {"start": s, "steps": n, "fired": False}
            for s, n in (windows or [])
        ]
        self.log_dir = log_dir
        self.signal_steps = signal_steps
        self.label = label
        self._requested = False  # SIGUSR2 arms this; next step() fires
        self._active_dir: str | None = None
        self._prof: Any = None
        self.windows: list[dict] = []  # closed windows, in order
        self._active_start = 0
        self._stop_at = 0
        self._prev_handler: Any = None
        self._signum: int | None = None

    # ----------------------------------------------------------- set-up

    @classmethod
    def from_env(
        cls,
        log_dir: str | None = None,
        install_signal: bool = False,
        label: str = "train",
    ) -> "StepTracer | None":
        """Build a tracer from ``KEYSTONE_PROFILE_STEPS``; installs the
        ``SIGUSR2`` handler when asked (main thread only — the caller
        checks). Returns None when there is nothing to do, so the train
        loop pays zero per-step cost. A malformed spec warns and is
        dropped — observability must not abort the run it watches."""
        spec = os.environ.get(ENV_PROFILE_STEPS, "")
        windows: list[tuple[int, int]] = []
        if spec:
            try:
                windows = parse_windows(spec)
            except ValueError as e:
                logger.warning("%s; profiling windows disabled", e)
        tracer = cls(windows, log_dir=log_dir, label=label)
        if install_signal:
            tracer.install_signal()
        if not windows and tracer._signum is None:
            return None
        return tracer

    def install_signal(self) -> None:
        """Arm ``SIGUSR2`` → on-demand window (no-op where the platform
        or thread context has no SIGUSR2)."""
        import signal as _signal

        if not hasattr(_signal, "SIGUSR2"):
            return
        if threading.current_thread() is not threading.main_thread():
            return
        def _on_usr2(signum, frame):  # noqa: ARG001
            self.request()

        try:
            self._prev_handler = _signal.signal(_signal.SIGUSR2, _on_usr2)
            self._signum = _signal.SIGUSR2
        except (ValueError, OSError):  # non-main thread raced us
            self._prev_handler = None
            self._signum = None

    def request(self, steps: int | None = None) -> None:
        """Arm an on-demand window starting at the next step boundary
        (what the SIGUSR2 handler calls; async-signal-safe: one flag)."""
        if steps is not None:
            self.signal_steps = steps
        self._requested = True

    # --------------------------------------------------------- per step

    def step(self, step: int) -> None:
        """Advance to ``step`` (about to dispatch): stop an expired
        window, then start a due one."""
        if self._active_dir is not None and step >= self._stop_at:
            self._stop_trace(step)
        if self._active_dir is not None:
            # mid-window: leave a pending SIGUSR2 request armed (it
            # fires at the first free step boundary) and env windows
            # un-fired rather than consuming them unstartable
            return
        want: tuple[int, int, str] | None = None
        if self._requested:
            self._requested = False
            want = (step, self.signal_steps, "sigusr2")
        else:
            for w in self._windows:
                if not w["fired"] and step >= w["start"]:
                    w["fired"] = True
                    # resume past the window's tail: nothing left to grab
                    if step < w["start"] + w["steps"]:
                        want = (step, w["start"] + w["steps"] - step, "env")
                    break
        if want is not None:
            self._start_trace(*want)

    def close(self) -> None:
        """Stop any in-flight window and restore the signal handler."""
        if self._active_dir is not None:
            self._stop_trace(self._stop_at)
        if self._signum is not None:
            import signal as _signal

            try:
                _signal.signal(self._signum, self._prev_handler)
            except (ValueError, OSError):
                pass
            self._signum = None

    # ---------------------------------------------------------- plumbing

    def _base_dir(self) -> str | None:
        env = os.environ.get(ENV_TRACE_DIR)
        if env is not None and env.lower() in _DISABLED_VALUES:
            return None  # the production kill switch beats everything
        if self.log_dir:
            return self.log_dir
        if env:
            return env
        log = _events.active()
        if log is not None and log.run_dir:
            return os.path.join(log.run_dir, "traces")
        return None

    def _start_trace(self, step: int, n_steps: int, reason: str) -> None:
        base = self._base_dir()
        if base is None:
            logger.warning(
                "profile window at step %d requested but no trace "
                "directory is configured (set %s or run under an "
                "observe sink); skipping",
                step,
                ENV_TRACE_DIR,
            )
            return
        trace_dir = os.path.join(base, f"step_{step}")
        try:
            self._prof = start_profiler(os.path.join(trace_dir, TRACE_FILE))
        except Exception as e:  # noqa: BLE001 — degrade, don't abort
            logger.warning(
                "profiler trace to %s unavailable (%r); running "
                "unprofiled",
                trace_dir,
                e,
            )
            return
        self._active_dir = trace_dir
        self._active_start = step
        self._stop_at = step + n_steps
        _metrics.get_registry().counter(
            "trace_windows", reason=reason
        ).inc()
        log = _events.active()
        if log is not None:
            log.emit(
                "trace_window",
                status="started",
                step=step,
                steps=n_steps,
                reason=reason,
                dir=trace_dir,
                label=self.label,
            )

    def _stop_trace(self, step: int) -> None:
        trace_dir, start = self._active_dir, self._active_start
        prof, self._prof = self._prof, None
        self._active_dir = None
        path = os.path.join(trace_dir, TRACE_FILE)
        audit = None
        try:
            stop_profiler(prof, path)
            audit = _audit(prof, path)
        except Exception as e:  # noqa: BLE001
            logger.warning("profiler stop failed: %r", e)
            status = "failed"
        else:
            if audit is not None and audit["all_device_events"] == 0:
                # the session saw no device activity: an empty window,
                # not a window in which nothing launched
                logger.warning(
                    "profile of steps %d-%d at %s holds no device events",
                    start,
                    step - 1,
                    path,
                )
                status, audit = "empty", None
            elif audit is not None and audit["lost"]:
                logger.warning(
                    "profile of steps %d-%d at %s lacks the device records of "
                    "%d launch(es): the window is incomplete",
                    start,
                    step - 1,
                    path,
                    audit["lost"],
                )
                status = "incomplete"
            else:
                logger.info(
                    "profile of steps %d-%d written to %s",
                    start,
                    step - 1,
                    path,
                )
                status = "ok"
        record = {
            "status": status,
            "step": start,
            "steps": step - start,
            "dir": trace_dir,
            "path": path,
            "device_events": None if audit is None else audit["device_events"],
            "lost_device_events": None if audit is None else audit["lost"],
            "primer_lost_events": None if audit is None else audit["primer_lost"],
        }
        self.windows.append(record)
        log = _events.active()
        if log is not None:
            log.emit("trace_window", label=self.label, **record)


def _audit(prof: Any, path: str) -> dict | None:
    """The device records of the session's trace (``core.profiling.
    audit_trace``), or None when it did not collect CUDA activity (no
    card)."""
    import torch

    if torch.profiler.ProfilerActivity.CUDA not in (prof.activities or ()):
        return None
    return audit_trace(path)
