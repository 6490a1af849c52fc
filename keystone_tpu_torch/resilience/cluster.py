"""Elastic multihost membership — port of
``keystone_tpu/resilience/cluster.py``: heartbeats, host-loss detection,
coordinated-checkpoint barriers and the exit-code protocol the run
supervisor (:mod:`keystone_tpu_torch.resilience.supervisor`) drives.

The JAX package rides the ``jax.distributed`` coordination service. The
port's channel is a ``torch.distributed.TCPStore`` at
``KEYSTONE_COORDINATOR`` (``HOST:PORT``), which the supervisor hosts for
each generation (:class:`StoreKV`); the process group that
:func:`keystone_tpu_torch.parallel.multihost.initialize` builds joins the
same store. A TCPStore cannot
list keys by prefix, so the failure detector reads the one heartbeat
key of each of the ``num_processes`` it knows (:meth:`LocalKV.get_many`,
:meth:`StoreKV.get_many`), and a read that fails in transport returns
``None`` — "coordinator gone" — never an empty answer and never a hang
past the client's short timeout.

- every process publishes ``keystone/cluster/heartbeat/<pid>`` on a
  ``KEYSTONE_HEARTBEAT_S`` cadence from a daemon thread (payload: a beat
  counter plus the last step :func:`note_step` recorded);
- process 0 runs the failure detector: a process whose payload stops
  changing for ``KEYSTONE_HEARTBEAT_TIMEOUT_S`` (measured on process 0's
  OWN monotonic clock — cross-host wall clocks are never compared) is
  declared dead, and the verdict is published under the poison key
  ``keystone/cluster/lost`` so every survivor sees it on its next beat;
- survivors exit the train loop cleanly (:class:`HostLostError`,
  translated to :data:`EXIT_HOST_LOST` at the process boundary by
  :func:`exit_on_cluster_error`) and the supervisor relaunches the job
  on the surviving set, restoring from the last coordinated checkpoint
  — at most one checkpoint interval of steps lost;
- a survivor wedged in a blocking call can't reach its loop check, so
  after ``KEYSTONE_HOSTLOSS_ABORT_S`` of being flagged the monitor
  hard-aborts the process (``os._exit``).

Deterministic drills: ``cluster.heartbeat_drop`` skips a publish at the
keyed beat, ``kv.partition`` drops a publish or a read, and
``cluster.host_kill`` SIGKILLs the process after the keyed train step,
all via the ``KEYSTONE_FAULTS`` grammar.

Stdlib-only at module import (torch loads inside the store functions);
the train-loop hooks (:func:`note_step`, :func:`check_lost`) are one
module-global read when no monitor is active. The monitor thread never
touches the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable

ENV_HEARTBEAT_S = "KEYSTONE_HEARTBEAT_S"
ENV_HEARTBEAT_TIMEOUT_S = "KEYSTONE_HEARTBEAT_TIMEOUT_S"
ENV_HOSTLOSS_ABORT_S = "KEYSTONE_HOSTLOSS_ABORT_S"
ENV_CKPT_BARRIER_S = "KEYSTONE_CKPT_BARRIER_S"

_DEFAULT_HEARTBEAT_S = 5.0
_DEFAULT_TIMEOUT_S = 30.0
_DEFAULT_ABORT_S = 20.0
_DEFAULT_CKPT_BARRIER_S = 120.0

#: Exit-code protocol between a supervised job and its supervisor. A
#: survivor that detected a peer loss exits EXIT_HOST_LOST ("re-mesh
#: me"); a watchdog-escalated wedge exits EXIT_WEDGED ("restart me in
#: place"). Both are restartable; any other nonzero exit is a real
#: failure the supervisor must NOT loop on.
EXIT_HOST_LOST = 113
EXIT_WEDGED = 114  # the watchdog's own constant (resilience/watchdog.py)
RESTARTABLE_EXITS = (EXIT_HOST_LOST, EXIT_WEDGED)

HEARTBEAT_PREFIX = "keystone/cluster/heartbeat/"
LOST_KEY = "keystone/cluster/lost"
BARRIER_PREFIX = "keystone/cluster/ckpt_barrier/"

ENV_COORDINATOR = "KEYSTONE_COORDINATOR"
ENV_PROCESS_ID = "KEYSTONE_PROCESS_ID"
ENV_NUM_PROCESSES = "KEYSTONE_NUM_PROCESSES"
ENV_RESTART = "KEYSTONE_RESTART"
#: a monitor's store client gives up on one call after this long: a hung
#: coordinator must read as "gone", not stall the heartbeat thread
MONITOR_STORE_TIMEOUT_S = 2.0


class ClusterError(RuntimeError):
    """Base of the membership-change error family. Deliberately never
    carries the transient RPC status words (UNAVAILABLE, ...) in its
    message: a membership change is not healed by retrying the call
    that noticed it."""


class HostLostError(ClusterError):
    """The failure detector has declared peer host(s) dead. The train
    loop raises this to exit cleanly; the process boundary translates
    it to :data:`EXIT_HOST_LOST` for the supervisor."""

    def __init__(self, lost, message: str | None = None):
        self.lost = tuple(sorted(int(p) for p in lost))
        super().__init__(
            message or f"cluster host(s) lost: {list(self.lost)}"
        )


class ClusterBarrierError(ClusterError):
    """A coordinated-checkpoint barrier timed out — a peer died or
    wedged mid-interval. The save is abandoned (never half-written) and
    the run falls back to the last intact checkpoint."""


class LocalKV:
    """In-process KV store with the coordination-service surface the
    monitor needs — the test transport, and a truthful stand-in for a
    single-process 'cluster'. ``set`` may be monkeypatched to raise to
    simulate a dead coordinator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, str] = {}

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value

    def get(self, key: str) -> str | None:
        with self._lock:
            return self._data.get(key)

    def get_many(self, keys) -> dict[str, str] | None:
        """The present keys among ``keys`` (absent ones are left out)."""
        with self._lock:
            return {k: self._data[k] for k in keys if k in self._data}

    def add(self, key: str, amount: int) -> int:
        with self._lock:
            value = int(self._data.get(key) or 0) + int(amount)
            self._data[key] = str(value)
            return value


class StoreKV:
    """A ``torch.distributed.TCPStore`` client, normalized to the surface
    :class:`ClusterMonitor` and :func:`checkpoint_barrier` use. ``get``
    returns None for an absent key (``check`` first: a TCPStore ``get``
    would block until the key appears); ``get_many`` returns None on a
    transport failure, so the caller can tell "empty" from "coordinator
    gone"; ``set`` and ``add`` raise on one."""

    def __init__(self, store):
        self._store = store

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def get(self, key: str) -> str | None:
        try:
            if not self._store.check([key]):
                return None
            return self._store.get(key).decode()
        except Exception:  # noqa: BLE001 — dead transport
            return None

    def get_many(self, keys) -> dict[str, str] | None:
        try:
            present = [k for k in keys if self._store.check([k])]
            values = self._store.multi_get(present) if present else []
        except Exception:  # noqa: BLE001 — transport failure
            return None
        return {k: v.decode() for k, v in zip(present, values)}

    def add(self, key: str, amount: int) -> int:
        return int(self._store.add(key, int(amount)))


def parse_address(address: str) -> tuple[str, int]:
    """``HOST:PORT`` → ``(host, port)``; raises ValueError otherwise."""
    host, sep, port = address.rpartition(":")
    if not (sep and host and port.isdigit()):
        raise ValueError(f"coordinator address {address!r}: expected HOST:PORT")
    return host, int(port)


def host_store(address: str, timeout_s: float = 300.0):
    """Start the TCPStore server at ``address`` (port 0 picks a free one;
    read it back as ``store.port``). The server lives as long as the
    returned object."""
    import datetime

    import torch.distributed as dist

    host, port = parse_address(address)
    return dist.TCPStore(
        host, port, is_master=True, wait_for_workers=False,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def connect_store(address: str, timeout_s: float):
    """A client of the TCPStore at ``address``, each call bounded by
    ``timeout_s``. Raises when nothing answers there within it."""
    import datetime

    import torch.distributed as dist

    host, port = parse_address(address)
    return dist.TCPStore(
        host, port, is_master=False, wait_for_workers=False,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def coordination_kv(timeout_s: float = MONITOR_STORE_TIMEOUT_S) -> StoreKV | None:
    """A KV client of the coordinator this process was launched with
    (``KEYSTONE_COORDINATOR``), or None when there is none or it does not
    answer."""
    address = os.environ.get(ENV_COORDINATOR, "").strip()
    if not address:
        return None
    try:
        return StoreKV(connect_store(address, timeout_s))
    except Exception:  # noqa: BLE001 — unreachable coordinator
        return None


def process_count() -> int:
    """The job's process count: the process group's world size when one
    is initialized, else ``KEYSTONE_NUM_PROCESSES`` (the supervisor's
    export), else 1."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:  # noqa: BLE001 — no usable torch.distributed
        pass
    return int(os.environ.get(ENV_NUM_PROCESSES, "") or 1)


def process_index() -> int:
    """This process's global id (see :func:`process_count`)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001
        pass
    return int(os.environ.get(ENV_PROCESS_ID, "") or 0)


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, "") or default)


class ClusterMonitor:
    """One process's view of cluster membership.

    Every process publishes heartbeats; host 0 additionally runs the
    failure detector and publishes the verdict. The monitor thread does
    all three on the heartbeat cadence; ``clock`` and ``abort`` are
    injectable so the whole protocol unit-tests with zero sleeping and
    zero real process kills (``beat_once``/``detect_once``/``tick`` are
    the thread's body, callable directly).
    """

    def __init__(
        self,
        kv,
        process_id: int,
        num_processes: int,
        *,
        interval_s: float | None = None,
        timeout_s: float | None = None,
        abort_after_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        abort: Callable[[int], None] = os._exit,
    ):
        self.kv = kv
        self.pid = int(process_id)
        self.nprocs = int(num_processes)
        self.interval_s = (
            interval_s
            if interval_s is not None
            else _env_float(ENV_HEARTBEAT_S, _DEFAULT_HEARTBEAT_S)
        )
        self.timeout_s = (
            timeout_s
            if timeout_s is not None
            else _env_float(ENV_HEARTBEAT_TIMEOUT_S, _DEFAULT_TIMEOUT_S)
        )
        self.abort_after_s = (
            abort_after_s
            if abort_after_s is not None
            else _env_float(ENV_HOSTLOSS_ABORT_S, _DEFAULT_ABORT_S)
        )
        if self.interval_s <= 0:
            raise ValueError(f"interval_s={self.interval_s}: must be > 0")
        if self.timeout_s <= self.interval_s:
            raise ValueError(
                f"timeout_s={self.timeout_s} must exceed the "
                f"{self.interval_s}s heartbeat interval — a detector "
                "faster than the publisher declares every host dead"
            )
        self.clock = clock
        self.abort = abort
        self.beats = 0
        self.step = 0
        self._lost: tuple[int, ...] | None = None
        self._lost_at: float | None = None
        self._aborted = False
        # detector state (host 0): pid -> (last payload, local time it
        # last CHANGED). Local monotonic time only — never a cross-host
        # wall-clock comparison.
        self._seen: dict[int, tuple[str | None, float]] = {}
        self._kv_reads = 0  # kv.partition read-key counter (string
        # domain "read:N" — disjoint from the integer beat keys, so a
        # keyed @N campaign step targets publishes without also eating
        # an unrelated detector/poll read)
        self._transport_down_since: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -------------------------------------------------- publish side

    def note_step(self, step: int) -> None:
        """Record training progress for the next heartbeat payload —
        a plain attribute write, safe on the hot path."""
        self.step = int(step)

    def beat_once(self, now: float | None = None) -> bool:
        """Publish one heartbeat (unless the ``cluster.heartbeat_drop``
        fault eats it). Returns True when the publish reached the KV
        store. Sustained publish failure on a non-coordinator host is
        itself a detection signal: the coordinator (host 0) is gone."""
        from keystone_tpu_torch.observe import metrics
        from keystone_tpu_torch.resilience import faults

        now = self.clock() if now is None else now
        beat = self.beats
        self.beats += 1
        if faults.fire("cluster.heartbeat_drop", key=beat):
            return False
        payload = json.dumps(
            {"pid": self.pid, "beat": beat, "step": self.step}
        )
        try:
            # kv.partition: the publish is DROPPED (never reaches the
            # store) — unlike heartbeat_drop it counts as transport
            # loss, so a fully partitioned non-coordinator walks the
            # same verdict path a dead coordinator produces
            if faults.fire("kv.partition", key=beat):
                raise faults.InjectedFault(
                    "injected fault at 'kv.partition' (publish dropped)"
                )
            self.kv.set(HEARTBEAT_PREFIX + str(self.pid), payload)
        except Exception as e:  # noqa: BLE001 — dead coordinator
            if self._transport_down_since is None:
                self._transport_down_since = now
            if (
                self.pid != 0
                and now - self._transport_down_since > self.timeout_s
            ):
                self._declare_lost(
                    (0,), "coordinator_unreachable", now, error=repr(e)
                )
            return False
        self._transport_down_since = None
        metrics.get_registry().counter("cluster_heartbeats").inc()
        metrics.get_registry().gauge("cluster_heartbeat_step").set(
            float(self.step)
        )
        return True

    def _next_read_key(self) -> str:
        """The kv.partition key for one KV *read* — a string
        ("read:N") so it can never alias onto the integer beat keys a
        campaign's ``at: N`` step targets; probability clauses still
        hash every read distinctly."""
        key = f"read:{self._kv_reads}"
        self._kv_reads += 1
        return key

    # --------------------------------------------------- detect side

    def detect_once(self, now: float | None = None) -> tuple[int, ...]:
        """Host 0's failure-detector pass: a peer whose heartbeat
        payload has not changed (on this host's monotonic clock) for
        ``timeout_s`` is dead. Publishes the verdict under
        :data:`LOST_KEY`. Returns the lost set (empty tuple = all
        alive)."""
        from keystone_tpu_torch.observe import metrics

        from keystone_tpu_torch.resilience import faults

        now = self.clock() if now is None else now
        if self._lost is not None:
            return self._lost
        # a partitioned detector read looks exactly like a transport
        # failure (get_many() returning None) — the kv.partition drill
        beats = (
            None
            if faults.fire("kv.partition", self._next_read_key())
            else self.kv.get_many(
                [HEARTBEAT_PREFIX + str(p) for p in range(self.nprocs) if p != self.pid]
            )
        )
        if beats is None:
            # transport failure on the detector itself — count it like
            # a publish failure; host 0 owns the coordinator, so this
            # only happens with an injected/external KV
            if self._transport_down_since is None:
                self._transport_down_since = now
            return ()
        lost: list[int] = []
        for pid in range(self.nprocs):
            if pid == self.pid:
                continue
            payload = beats.get(HEARTBEAT_PREFIX + str(pid))
            prev = self._seen.get(pid)
            if prev is None or prev[0] != payload:
                # first sight, or fresh beat: (re)start this host's
                # silence clock. A host that has never published is
                # measured from monitor start.
                self._seen[pid] = (payload, now)
                if payload is not None:
                    continue
            last_change = self._seen[pid][1]
            if now - last_change > self.timeout_s:
                lost.append(pid)
        alive = self.nprocs - len(lost)
        metrics.get_registry().gauge("cluster_alive_hosts").set(
            float(alive)
        )
        if lost:
            try:
                self.kv.set(
                    LOST_KEY,
                    json.dumps({"lost": lost, "detected_by": self.pid}),
                )
            except Exception:  # noqa: BLE001 — verdict still applies
                # locally even when the poison key can't be published
                pass
            self._declare_lost(lost, "heartbeat_timeout", now)
        return tuple(lost)

    def poll_lost_key(self, now: float | None = None) -> None:
        """Non-detector hosts: pick up host 0's published verdict."""
        from keystone_tpu_torch.resilience import faults

        if self._lost is not None:
            return
        raw = (
            None
            if faults.fire("kv.partition", self._next_read_key())
            else self.kv.get(LOST_KEY)
        )
        if not raw:
            return
        try:
            verdict = json.loads(raw)
            lost = [int(p) for p in verdict.get("lost", ())]
        except (ValueError, TypeError):
            return
        if lost:
            self._declare_lost(
                lost,
                "peer_verdict",
                self.clock() if now is None else now,
                detected_by=verdict.get("detected_by"),
            )

    def _declare_lost(
        self,
        lost,
        reason: str,
        now: float,
        **fields: Any,
    ) -> None:
        if self._lost is not None:
            return
        self._lost = tuple(sorted(int(p) for p in lost))
        self._lost_at = now
        from keystone_tpu_torch.core.logging import get_logger
        from keystone_tpu_torch.observe import metrics

        get_logger("keystone_tpu_torch.resilience").warning(
            "cluster: host(s) %s declared lost (%s) — exiting for "
            "re-mesh; the supervisor restores from the last coordinated "
            "checkpoint",
            list(self._lost),
            reason,
        )
        metrics.get_registry().counter("cluster_hosts_lost").inc(
            len(self._lost)
        )
        metrics.get_registry().gauge("cluster_alive_hosts").set(
            float(self.nprocs - len(self._lost))
        )
        emit_event(
            "host_lost",
            lost=list(self._lost),
            reason=reason,
            pid=self.pid,
            step=self.step,
            **fields,
        )

    # ----------------------------------------------------- lifecycle

    def check(self) -> tuple[int, ...] | None:
        """The train loop's poll: the lost host set once declared, else
        None. A plain attribute read."""
        return self._lost

    def tick(self, now: float | None = None) -> None:
        """One monitor iteration: publish, detect (host 0) or poll the
        verdict (others), and escalate to a hard abort when the flagged
        process failed to exit within the grace window (it is wedged in
        a collective whose peer is dead — only ``os._exit`` still
        works; the supervisor takes it from there)."""
        now = self.clock() if now is None else now
        self.beat_once(now)
        if self.pid == 0:
            self.detect_once(now)
        else:
            self.poll_lost_key(now)
        if (
            self._lost is not None
            and not self._aborted
            and self.abort_after_s > 0
            and self._lost_at is not None
            and now - self._lost_at > self.abort_after_s
        ):
            self._aborted = True
            from keystone_tpu_torch.core.logging import get_logger
            from keystone_tpu_torch.resilience.watchdog import dump_stacks

            get_logger("keystone_tpu_torch.resilience").critical(
                "cluster: process still running %.1fs after host loss "
                "(blocked collective?) — hard abort for supervisor "
                "relaunch; thread stacks:\n%s",
                now - self._lost_at,
                dump_stacks(),
            )
            emit_event(
                "host_loss_abort",
                lost=list(self._lost),
                pid=self.pid,
                grace_s=self.abort_after_s,
            )
            self.abort(EXIT_HOST_LOST)

    def start(self) -> "ClusterMonitor":
        self._thread = threading.Thread(
            target=self._run, name="cluster-monitor", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the monitor must outlive
                # any single bad iteration (a torn KV payload, a store
                # teardown race); detection resumes next tick
                from keystone_tpu_torch.core.logging import get_logger

                get_logger("keystone_tpu_torch.resilience").exception(
                    "cluster monitor tick failed; continuing"
                )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# Module-global monitor, the faults.active() idiom: the train loop's
# per-step hooks are one global read when no monitor is running.
_monitor: ClusterMonitor | None = None
_state_lock = threading.Lock()


def start_monitor(
    process_id: int | None = None,
    num_processes: int | None = None,
    kv=None,
    **kwargs: Any,
) -> ClusterMonitor | None:
    """Start this process's membership monitor (idempotent). Resolves
    pid/nprocs from :func:`process_index` / :func:`process_count` when
    not given; returns None — and starts nothing — for a single-process
    run without a ``kv``, or when no coordinator answers (nothing to
    monitor, nothing to publish to)."""
    global _monitor
    if process_id is None or num_processes is None:
        num_processes = process_count()
        process_id = process_index()
    if num_processes <= 1 and kv is None:
        return None
    if kv is None:
        kv = coordination_kv()
        if kv is None:
            from keystone_tpu_torch.core.logging import get_logger

            get_logger("keystone_tpu_torch.resilience").warning(
                "cluster: no coordinator at %s=%r — membership monitoring "
                "disabled", ENV_COORDINATOR, os.environ.get(ENV_COORDINATOR, ""),
            )
            return None
    with _state_lock:
        if _monitor is not None:
            return _monitor
        _monitor = ClusterMonitor(
            kv, process_id, num_processes, **kwargs
        ).start()
        emit_event(
            "monitor_start",
            pid=process_id,
            hosts=num_processes,
            interval_s=_monitor.interval_s,
            timeout_s=_monitor.timeout_s,
        )
        return _monitor


def active_monitor() -> ClusterMonitor | None:
    return _monitor


def stop_monitor() -> None:
    global _monitor
    with _state_lock:
        mon, _monitor = _monitor, None
    if mon is not None:
        mon.stop()


def note_step(step: int) -> None:
    """Per-step progress hook for training loops — ONE global read when
    no monitor is active."""
    mon = _monitor
    if mon is not None:
        mon.note_step(step)


def check_lost() -> tuple[int, ...] | None:
    """The train loop's membership poll: lost host pids once declared,
    else None. ONE global read when no monitor is active."""
    mon = _monitor
    if mon is not None:
        return mon.check()
    return None


_barrier_kv: Any = None


def _barrier_store():
    """The barrier's client of the coordinator (made once), or None."""
    global _barrier_kv
    with _state_lock:
        if _barrier_kv is None:
            _barrier_kv = coordination_kv(timeout_s=10.0)
        return _barrier_kv


def checkpoint_barrier(
    step: int, timeout_s: float | None = None, kv=None, phase: str = ""
) -> bool:
    """Agreement point before a coordinated checkpoint save: every process
    must arrive at ``step``'s save before any starts writing, so a dead or
    wedged peer turns into a loud :class:`ClusterBarrierError` (bounded by
    ``KEYSTONE_CKPT_BARRIER_S``) instead of a torn checkpoint or an
    unbounded hang. No-op (returns False) for single-process runs and
    runs without a coordinator.

    The barrier is an ``add`` counter keyed by the supervisor generation
    (``KEYSTONE_RESTART``) and the step, read until it reaches the
    process count: a relaunched generation never sees the counts of the
    one before it (single-box mode also gives each generation a fresh
    store). ``phase`` names a second barrier at the same step (the
    coordinated save's "saved")."""
    nprocs = process_count()
    if nprocs <= 1:
        return False
    if kv is None:
        kv = _barrier_store()
        if kv is None:
            return False
    if timeout_s is None:
        timeout_s = _env_float(ENV_CKPT_BARRIER_S, _DEFAULT_CKPT_BARRIER_S)
    key = f"{BARRIER_PREFIX}{os.environ.get(ENV_RESTART, '0') or '0'}/{int(step)}"
    if phase:
        key = f"{key}/{phase}"
    deadline = time.monotonic() + timeout_s
    try:
        arrived = kv.add(key, 1)
        while arrived < nprocs:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{arrived}/{nprocs} processes arrived")
            time.sleep(0.01)
            arrived = kv.add(key, 0)
    except Exception as e:  # noqa: BLE001 — wrapped with diagnosis
        # message deliberately free of the transient RPC status words:
        # retrying the save against a dead peer cannot succeed
        raise ClusterBarrierError(
            f"coordinated checkpoint barrier for step {step} failed "
            f"after {timeout_s:.0f}s — a peer host died or wedged "
            "mid-interval; falling back to the last intact checkpoint. "
            f"Underlying error: {e!r}"
        ) from e
    return True


@contextlib.contextmanager
def exit_on_cluster_error():
    """The process boundary of the supervisor's exit-code protocol: a
    :class:`ClusterError` escaping the block exits :data:`EXIT_HOST_LOST`
    (a re-mesh request, not a crash); the monitor stops either way."""
    import sys

    try:
        yield
    except ClusterError as e:
        print(f"# host loss: {e}", file=sys.stderr, flush=True)
        raise SystemExit(EXIT_HOST_LOST) from e
    finally:
        stop_monitor()


def emit_event(action: str, **fields: Any) -> None:
    """One ``cluster`` event + counter — the membership analog of the
    resilience :func:`~keystone_tpu_torch.resilience.emit.decision` schema,
    rendered by ``observe <dir>`` and ``observe top``."""
    from keystone_tpu_torch.resilience.emit import decision

    decision(
        action,
        counter="cluster_events",
        counter_labels={"action": action},
        event_kind="cluster",
        phase="cluster",
        **fields,
    )
