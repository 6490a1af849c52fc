"""Retry with exponential backoff — the transient-IO survival policy.

The port's copy of ``keystone_tpu/resilience/retry.py`` (stdlib only),
its imports pointed at ``keystone_tpu_torch``.

Spark gave the reference task re-execution for free; here the unit of
retry is a Python call (a tar open, a checkpoint save, an accelerator
probe). One :class:`RetryPolicy` object is the whole policy: attempt
cap, exponential backoff with deterministic jitter, an overall
deadline, and a *transient-error classifier* — a permanent error
(corrupt archive header, shape mismatch) re-raises immediately instead
of burning the deadline.

The clock is injectable (``sleep``/``monotonic``) so the fault-matrix
tests run the full schedule with zero real sleeping, and jitter is
seeded so a retry trace replays exactly.

Every retry decision is observable: a ``resilience`` event (when an
event sink is active) and a ``retries{label=...}`` counter.
"""

from __future__ import annotations

import dataclasses
import errno
import tarfile
import time
from typing import Any, Callable


def is_transient(exc: BaseException) -> bool:
    """Default classifier: IO/transfer/RPC errors worth retrying.

    - ``OSError`` (IOError, ConnectionError, TimeoutError) and
      ``EOFError`` — the host-side IO family, including the injected
      :class:`~keystone_tpu_torch.resilience.faults.InjectedFault` — EXCEPT
      the wrong-path family (``FileNotFoundError``/``PermissionError``/
      ``NotADirectoryError``/``IsADirectoryError``): a typo'd path
      doesn't heal on retry, and burying it under RetryExhausted would
      hide the one error message the user needs;
    - runtime errors whose message carries an RPC status for a
      recoverable condition (``UNAVAILABLE``, ``DEADLINE_EXCEEDED``,
      ``ABORTED``) — matched on the message, not the type.
      ``RESOURCE_EXHAUSTED`` (OOM) is deliberately NOT transient:
      retrying an OOM just re-OOMs.

    ``tarfile.ReadError`` (corrupt/garbled archive) is deliberately NOT
    transient: corruption doesn't heal on retry — it fails straight
    through to the caller's skip-the-archive path.
    """
    if isinstance(exc, tarfile.ReadError):
        return False
    if isinstance(
        exc,
        (
            FileNotFoundError,
            PermissionError,
            NotADirectoryError,
            IsADirectoryError,
        ),
    ):
        return False
    if isinstance(exc, OSError) and exc.errno in (
        errno.ENOSPC,
        errno.EDQUOT,
    ):
        # a full disk / blown quota does not heal on a 100 ms backoff —
        # retrying just burns the deadline in front of the one error
        # message the operator needs; callers with a real degrade path
        # (the train loop's periodic save) handle it explicitly
        return False
    if isinstance(exc, (OSError, EOFError)):
        return True
    msg = str(exc)
    return any(
        code in msg
        for code in ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED")
    )


class RetryExhausted(RuntimeError):
    """All attempts failed with transient errors; carries the last one
    as ``__cause__``."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter + deadline over a classified call.

    ``delay(i) = min(base * multiplier**i, max_delay) * (1 ± jitter)``
    with the jitter factor drawn from a seeded hash of the attempt
    index — deterministic, so CI retry traces replay.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.1
    deadline_s: float | None = None
    classify: Callable[[BaseException], bool] = is_transient
    seed: int = 0
    # injectable clock: the fault-matrix tests run the whole schedule
    # without sleeping; production uses the real one
    sleep: Callable[[float], None] = time.sleep
    monotonic: Callable[[], float] = time.monotonic

    def delay_s(self, attempt: int) -> float:
        """The post-failure delay before attempt ``attempt + 1``."""
        raw = min(
            self.base_delay_s * self.multiplier**attempt, self.max_delay_s
        )
        if not self.jitter:
            return raw
        from keystone_tpu_torch.resilience.faults import unit_hash

        unit = unit_hash(self.seed, "retry.jitter", attempt)
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * unit)

    def call(self, fn: Callable[[], Any], *, label: str = "") -> Any:
        """Run ``fn`` under this policy. Non-transient errors pass
        through untouched; transient ones retry until the attempt cap
        or deadline, then raise :class:`RetryExhausted`."""
        label = label or getattr(fn, "__name__", "call")
        start = self.monotonic()
        last: BaseException | None = None
        attempts_made = 0
        deadline_hit = False
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self.classify(e):
                    raise
                last = e
                attempts_made = attempt + 1
                delay = self.delay_s(attempt)
                # an explicit server back-off wins over our schedule: a
                # transient error carrying ``retry_after_s`` (a shed 503
                # with a Retry-After header, surfaced by the fleet
                # transport) stretches the delay to at least that — the
                # whole point of the header is that N clients retrying
                # on their own eager schedules re-stampede the very
                # overload that shed them
                ra = getattr(e, "retry_after_s", None)
                if isinstance(ra, (int, float)) and ra > delay:
                    delay = float(ra)
                elapsed = self.monotonic() - start
                deadline_hit = (
                    self.deadline_s is not None
                    and elapsed + delay > self.deadline_s
                )
                final = attempts_made >= self.max_attempts or deadline_hit
                self._observe(label, attempt, delay, e, final)
                if final:
                    break
                self.sleep(delay)
        raise RetryExhausted(
            f"{label}: {attempts_made}/{self.max_attempts} attempts "
            "failed"
            + (" (deadline exceeded)" if deadline_hit else "")
            + f" (last: {last!r})"
        ) from last

    def _observe(
        self,
        label: str,
        attempt: int,
        delay: float,
        exc: BaseException,
        final: bool,
    ) -> None:
        from keystone_tpu_torch.resilience.emit import decision

        decision(
            "retry_exhausted" if final else "retry",
            counter="retries",
            counter_labels={"label": label},
            label=label,
            attempt=attempt,
            delay_s=delay,
            error=repr(exc),
        )


def retrying(policy: RetryPolicy, label: str = ""):
    """Decorator form: ``@retrying(policy)`` wraps a zero-result-shape
    function so every call runs under the policy."""
    import functools

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            return policy.call(
                lambda: fn(*args, **kw), label=label or fn.__name__
            )

        return inner

    return wrap


#: Host-side file IO: quick, bounded — a flaky NFS/tunnel read gets two
#: more chances over ~0.3 s, a corrupt file fails fast to the caller's
#: skip path.
IO_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.05, deadline_s=10.0)

#: Checkpoint save/restore: the write is the run's survival, so be
#: patient — five attempts over up to a minute.
CHECKPOINT_POLICY = RetryPolicy(
    max_attempts=5, base_delay_s=0.5, max_delay_s=15.0, deadline_s=60.0
)
