"""Multi-process execution — port of ``keystone_tpu/parallel/multihost.py``.

The JAX package joins its processes with ``jax.distributed.initialize``
and assembles global arrays from process-local rows. The port runs one
process per card on a ``torch.distributed`` process group:

- NCCL between cards; gloo for a process on the CPU, and gloo when two
  processes share one card, because NCCL refuses two ranks on one device
  (:func:`initialize` raises for that case, naming ``backend="gloo"``);
- the group rides the ``torch.distributed.TCPStore`` at
  ``KEYSTONE_COORDINATOR`` that the run supervisor hosts for each
  generation and that :mod:`keystone_tpu_torch.resilience.cluster`'s
  heartbeats and checkpoint barriers already use. Launched without a
  supervisor, process 0 hosts that store itself;
- a global batch is a :class:`GlobalRows`: this process's rows on its own
  card, with the global row count and the rows' offset. The fits, the
  evaluator and the planner read it as the reference reads a data-sharded
  global array: each process reduces its own rows, and one collective
  makes the result global.

Typical launch, the same command in every process::

    python -m keystone_tpu_torch supervise --procs N -- \\
        python -m keystone_tpu_torch --multihost <pipeline> ...
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import json
import os
import socket
import time
from typing import Any

import torch

from keystone_tpu_torch.core.logging import get_logger

logger = get_logger("keystone_tpu_torch.parallel.multihost")

#: merged cluster metrics written by :func:`rollup_metrics` on process 0,
#: rendered by ``python -m keystone_tpu_torch observe <run-dir>``
CLUSTER_METRICS_FILE = "metrics_cluster.json"

# per-process roll-up sequence: every process calls rollup_metrics in the
# same program order, so the counter yields matching store keys
_rollup_seq = itertools.count()

#: env override for :func:`initialize`'s ``init_timeout_s``.
ENV_INIT_TIMEOUT = "KEYSTONE_INIT_TIMEOUT_S"
_DEFAULT_INIT_TIMEOUT_S = 300.0

_ENV_COORDINATOR = "KEYSTONE_COORDINATOR"
_ENV_PROCESS_ID = "KEYSTONE_PROCESS_ID"
_ENV_NUM_PROCESSES = "KEYSTONE_NUM_PROCESSES"


@dataclasses.dataclass
class _Group:
    """This process's membership: its rank, the world, the backend, its
    device, every rank's device and host name in rank order, and the store
    client the key-value exchanges and barriers use (``server`` is the
    store itself when this process hosts it)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    devices: tuple
    hosts: tuple
    store: Any
    prefix: str
    server: Any = None
    address: str = ""


_group: _Group | None = None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    init_timeout_s: float | None = None,
    *,
    backend: str | None = None,
    device=None,
) -> torch.device:
    """Join this process into the job's process group; returns this
    process's device.

    The wiring comes from the arguments, else from the run supervisor's
    ``KEYSTONE_COORDINATOR`` / ``KEYSTONE_PROCESS_ID`` /
    ``KEYSTONE_NUM_PROCESSES``, which must be set as a group. With
    neither, the process forms a group of one. ``init_timeout_s``
    (default ``KEYSTONE_INIT_TIMEOUT_S``, else 300) bounds the join: a
    non-zero process first polls the coordinator's TCP port, so a dead
    coordinator fails in seconds with its address in the message.

    ``device`` defaults to card ``LOCAL_RANK`` (else the rank) when CUDA
    is present, else the CPU; ``backend`` defaults to NCCL on a card and
    gloo on the CPU. NCCL refuses two ranks on one card: that case raises
    and names ``backend="gloo"``, which runs them on one card."""
    global _group
    if _group is not None:
        return _group.device
    if init_timeout_s is None:
        init_timeout_s = float(os.environ.get(ENV_INIT_TIMEOUT, "") or _DEFAULT_INIT_TIMEOUT_S)
    if coordinator_address is None and os.environ.get(_ENV_COORDINATOR):
        coordinator_address = os.environ[_ENV_COORDINATOR]
        missing = [
            name
            for arg, name in (
                (num_processes, _ENV_NUM_PROCESSES),
                (process_id, _ENV_PROCESS_ID),
            )
            if arg is None and name not in os.environ
        ]
        if missing:
            raise RuntimeError(
                "KEYSTONE_COORDINATOR is set "
                f"({coordinator_address!r}) but {' and '.join(missing)} "
                "is not — the three variables wire one cluster together "
                "and must be set as a group (the run supervisor exports "
                "all of them; a manual launch must too). Unset "
                "KEYSTONE_COORDINATOR to run one process alone."
            )
        if num_processes is None:
            num_processes = int(os.environ[_ENV_NUM_PROCESSES])
        if process_id is None:
            process_id = int(os.environ[_ENV_PROCESS_ID])
    if coordinator_address is None:
        # a group of one, on a store of its own
        coordinator_address, num_processes, process_id = "127.0.0.1:0", 1, 0
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize(coordinator_address=...) needs num_processes and process_id too"
        )
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a world of {num_processes}")
    if process_id != 0:
        _preflight_coordinator(coordinator_address, init_timeout_s, process_id)
    device, backend = _resolve_device_backend(device, backend, process_id)

    import torch.distributed as dist

    from keystone_tpu_torch.resilience import cluster

    try:
        server = None
        if process_id == 0 and not _answers(coordinator_address):
            server = cluster.host_store(coordinator_address, init_timeout_s)
            store = server
            if coordinator_address.endswith(":0"):
                coordinator_address = f"{coordinator_address.rpartition(':')[0]}:{server.port}"
        else:
            store = cluster.connect_store(coordinator_address, init_timeout_s)
    except Exception as e:  # noqa: BLE001 — re-raised with diagnosis
        raise _init_error(coordinator_address, init_timeout_s, process_id, num_processes, e) from e
    restart = os.environ.get(cluster.ENV_RESTART, "0") or "0"
    prefix = f"keystone/pg/{restart}/"
    devices, hosts = _exchange_devices(
        store, prefix, device, backend, process_id, num_processes, init_timeout_s
    )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend,
            store=dist.PrefixStore(prefix, store),
            rank=process_id,
            world_size=num_processes,
            timeout=datetime.timedelta(seconds=max(init_timeout_s, 1.0)),
        )
    except Exception as e:  # noqa: BLE001 — re-raised with diagnosis
        raise _init_error(coordinator_address, init_timeout_s, process_id, num_processes, e) from e
    _group = _Group(
        rank=process_id,
        world=num_processes,
        backend=backend,
        device=device,
        devices=devices,
        hosts=hosts,
        store=store,
        prefix=prefix,
        server=server,
        address=coordinator_address,
    )
    # the cluster layer (heartbeats, checkpoint barriers) finds the same
    # coordinator through the supervisor's variables
    os.environ[_ENV_COORDINATOR] = coordinator_address
    os.environ[_ENV_PROCESS_ID] = str(process_id)
    os.environ[_ENV_NUM_PROCESSES] = str(num_processes)
    logger.info(
        "multihost: process %d/%d on %s over %s", process_id, num_processes, device, backend
    )
    return device


def _init_error(addr, timeout_s, process_id, num_processes, e) -> RuntimeError:
    return RuntimeError(
        f"multihost initialize failed (timeout {timeout_s:.0f}s, "
        f"coordinator {addr}, process_id={process_id}, "
        f"num_processes={num_processes}): every process must run the "
        "same command and reach the coordinator; check that no "
        f"worker died or was preempted. Underlying error: {e!r}"
    )


def _resolve_device_backend(device, backend, rank: int) -> tuple[torch.device, str]:
    """This process's device and the group's backend (see
    :func:`initialize`)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("initialize(device='cuda') but CUDA has no device")
        local = int(os.environ.get("LOCAL_RANK", "") or rank)
        device = torch.device("cuda", local % n)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}; expected 'nccl' or 'gloo'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend='nccl' needs a card; this process's device is {device}")
    return device, backend


def _card_identity(device: torch.device) -> str:
    """A name for the physical card (or the host, for the CPU) that two
    processes on one machine agree on."""
    host = socket.gethostname()
    if device.type != "cuda":
        return f"{host}:cpu"
    try:
        return f"{host}:{torch.cuda.get_device_properties(device).uuid}"
    except Exception:  # noqa: BLE001 — older torch: no uuid
        return f"{host}:cuda:{device.index}"


def _exchange_devices(store, prefix, device, backend, rank, world, timeout_s) -> tuple:
    """Every rank's device and host name, in rank order, traded over the
    store; under NCCL, raises when two ranks hold one card."""
    key = f"{prefix}device/"
    store.set(f"{key}{rank}", json.dumps({"device": str(device), "card": _card_identity(device),
                                          "host": socket.gethostname()}))
    keys = [f"{key}{r}" for r in range(world)]
    store.wait(keys, datetime.timedelta(seconds=max(timeout_s, 1.0)))
    infos = [json.loads(store.get(k)) for k in keys]
    if backend == "nccl":
        seen: dict = {}
        for r, info in enumerate(infos):
            if info["card"] in seen:
                raise RuntimeError(
                    f"two ranks on one card: ranks {seen[info['card']]} and {r} both hold "
                    f"{info['device']} ({info['card']}). NCCL refuses two ranks on one "
                    "device; pass backend='gloo' to initialize() to run them on one card, "
                    "or give each rank a card of its own."
                )
            seen[info["card"]] = r
    return (tuple(torch.device(info["device"]) for info in infos),
            tuple(info["host"] for info in infos))


def _answers(addr: str) -> bool:
    """True when something listens at ``HOST:PORT`` (a supervisor's store)."""
    host, _, port = addr.rpartition(":")
    host = host.strip("[]")
    if not host or not port.isdigit() or int(port) == 0:
        return False
    try:
        with socket.create_connection((host, int(port)), timeout=1.0):
            return True
    except OSError:
        return False


def _preflight_coordinator(addr: str, timeout_s: float, process_id: int) -> None:
    """Bounded poll of the coordinator's TCP port before joining: a dead
    coordinator fails cleanly, fast, and with the address in the
    message."""
    host, _, port = addr.rpartition(":")
    host = host.strip("[]")  # bracketed IPv6
    if not host or not port.isdigit():
        # unparseable address: the store's own client does the validating
        return
    deadline = time.monotonic() + timeout_s
    last: Exception | None = None
    while True:
        # at least one attempt even when timeout_s is 0 or tiny
        try:
            with socket.create_connection((host, int(port)), timeout=1.0):
                return
        except OSError as e:
            last = e
        if time.monotonic() >= deadline:
            break
        time.sleep(0.2)
    raise RuntimeError(
        f"multihost initialize: coordinator {addr} unreachable after "
        f"{timeout_s:.0f}s (process_id={process_id}); the coordinator "
        "(process 0) must be running and reachable before workers join. "
        f"Last error: {last!r}"
    )


def shutdown() -> None:
    """Leave the process group (and stop the store this process hosts)."""
    global _group
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _group = None


# ------------------------------------------------------------- membership


def is_initialized() -> bool:
    """True once :func:`initialize` has run in this process."""
    return _group is not None


def _dist_group():
    """``torch.distributed`` when a default process group is up (ours, or
    one the caller built), else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    """The process group's world size (1 outside a group)."""
    if _group is not None:
        return _group.world
    dist = _dist_group()
    return int(dist.get_world_size()) if dist is not None else 1


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    if _group is not None:
        return _group.rank
    dist = _dist_group()
    return int(dist.get_rank()) if dist is not None else 0


def local_device() -> torch.device | None:
    """This process's device in the group, or None outside one."""
    return _group.device if _group is not None else None


def group_devices() -> tuple:
    """Every rank's device in rank order (empty outside a group)."""
    return _group.devices if _group is not None else ()


def group_hosts() -> tuple:
    """Every rank's host name in rank order (empty outside a group)."""
    return _group.hosts if _group is not None else ()


def _require_group() -> _Group:
    if _group is None:
        raise RuntimeError("no process group: call multihost.initialize() first")
    return _group


def _backend() -> str:
    if _group is not None:
        return _group.backend
    return str(_dist_group().get_backend())


# ------------------------------------------------------------ collectives


def _staged(t: torch.Tensor) -> torch.Tensor:
    """What the backend can reduce: gloo stages a card's tensor through
    the host."""
    if _backend() == "gloo" and t.device.type != "cpu":
        return t.cpu()
    return t


def _line(group) -> tuple:
    """``(process group, size)`` of ``group``: an
    :class:`~keystone_tpu_torch.parallel.collectives.AxisGroup` (a line of
    a mesh), or None for every process of the group."""
    if group is None:
        return None, process_count()
    return group.pg, group.size


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """Reduce ``t`` in place over the group (``sum`` or ``max``), or over
    ``group`` (an ``AxisGroup``) when given; returns ``t``. A group of one
    leaves it as it is."""
    import torch.distributed as dist

    pg, size = _line(group)
    if size == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = _staged(t)
    dist.all_reduce(buf, op=red, group=pg)
    if buf is not t:
        t.copy_(buf)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` in place with rank ``src``'s value."""
    import torch.distributed as dist

    if process_count() == 1:
        return t
    buf = _staged(t)
    dist.broadcast(buf, src=src)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on every rank), in rank
    order (``group``'s order when given), on ``t``'s device."""
    import torch.distributed as dist

    pg, size = _line(group)
    if size == 1:
        return [t]
    buf = _staged(t.contiguous())
    outs = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(outs, buf, group=pg)
    return [o.to(t.device) for o in outs]


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``t`` (of ``group``'s ranks when given)
    concatenated in order; the ranks may hold different row counts (none
    at all included), and a rank with no rows may hold a (0, 0) array."""
    if _line(group)[1] == 1:
        return t
    meta = torch.tensor([t.shape[0], *t.shape[1:]], dtype=torch.int64)
    metas = all_gather_meta(meta, group)
    counts = [int(m[0]) for m in metas]
    tail = tuple(int(v) for v in torch.stack(metas).max(0).values[1:])
    n_max = max(max(counts), 1)
    pad = torch.zeros((n_max, *tail), dtype=t.dtype, device=t.device)
    if t.numel():
        pad[tuple(slice(0, s) for s in t.shape)] = t
    parts = all_gather(pad, group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)], dim=0)


def all_gather_meta(meta: torch.Tensor, group=None) -> list[torch.Tensor]:
    """A small int64 vector from every rank (the same length on each),
    through the host."""
    dev = torch.device("cpu")
    if _backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    return [m.cpu() for m in all_gather(meta.to(dev), group)]


def barrier(name: str, timeout_s: float = 60.0) -> None:
    """Wait until every rank reached ``name`` on the group's store;
    raises ``TimeoutError`` when one does not within ``timeout_s``."""
    g = _require_group()
    if g.world == 1:
        return
    key = f"{g.prefix}barrier/{name}"
    arrived = g.store.add(key, 1)
    deadline = time.monotonic() + timeout_s
    while arrived < g.world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"barrier {name!r}: {arrived}/{g.world} processes arrived")
        time.sleep(0.005)
        arrived = g.store.add(key, 0)


# ----------------------------------------------------------- global rows


@dataclasses.dataclass(frozen=True)
class GlobalRows:
    """A global batch as this process holds it — the counterpart of a
    data-sharded ``jax.Array``: ``local`` is this process's rows on its
    own card (a tensor, or a list of feature blocks of the same rows),
    ``n_global`` the valid rows of the whole batch and ``offset`` the
    global index of ``local``'s first row. Rows of ``local`` at or past
    ``n_global - offset`` are padding.

    ``group`` says which processes hold the row blocks once each: None
    for every process in rank order, or an
    :class:`~keystone_tpu_torch.parallel.collectives.AxisGroup`, this
    process's line along the data axis of a mesh across processes
    (:func:`keystone_tpu_torch.parallel.mesh.data_group`). On a mesh with a
    model (or pipe) axis every position of one data row holds the same
    rows, as the reference's ``data_sharding`` replicates over ``model``;
    a consumer reduces over ``group`` and so counts each row once."""

    local: Any
    n_global: int
    offset: int
    group: Any = None

    @property
    def n_local(self) -> int:
        first = self.local[0] if isinstance(self.local, (list, tuple)) else self.local
        return int(first.shape[0])

    @property
    def n_valid(self) -> int:
        """This process's valid rows."""
        return max(0, min(self.n_local, self.n_global - self.offset))

    def gather(self) -> torch.Tensor:
        """Every valid row of the batch, in order, on every process."""
        return all_gather_rows(self.local[: self.n_valid], self.group)


def row_block(n: int, rank: int | None = None, world: int | None = None) -> tuple[int, int]:
    """``(lo, hi)``: the rows of an ``n``-row batch, padded to a multiple
    of ``world``, that rank ``rank`` holds. ``hi`` may pass ``n``: the
    block then ends in pad rows."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    block = -(-int(n) // world) if n else 1
    return rank * block, (rank + 1) * block


def global_batch_from_local(local_batch, mesh=None, ndim: int | None = None) -> GlobalRows:
    """Assemble a global batch from this process's local rows (the
    counterpart of ``jax.make_array_from_process_local_data``): the rows
    go to this process's card, and every process learns the global row
    count and its rows' offset. Without a mesh every process holds one
    row block, in rank order. Over a ``mesh`` across processes the blocks
    lie along its data axis: the processes of one data row pass the same
    rows (their replicas), and the rows are counted over one process a
    data position. ``ndim`` is the reference's argument."""
    del ndim
    import numpy as np

    x = torch.from_numpy(np.ascontiguousarray(local_batch)) if isinstance(
        local_batch, np.ndarray) else torch.as_tensor(local_batch)
    g = _require_group()
    x = x.to(g.device)
    group, index = None, g.rank
    if mesh is not None and mesh.spans_processes:
        from keystone_tpu_torch.parallel.mesh import data_group

        group = data_group(mesh)
        index = group.index
    counts = [int(m[0]) for m in all_gather_meta(torch.tensor([x.shape[0]]), group)]
    return GlobalRows(x, sum(counts), sum(counts[:index]), group)


# ------------------------------------------------------ metrics roll-up


def merge_metric_dumps(dumps: list[dict]) -> dict:
    """Merge per-process kind-tagged metric dumps
    (:meth:`keystone_tpu_torch.observe.metrics.MetricsRegistry.dump`) into
    cluster totals: counters sum, gauges take the max (the cluster's
    memory peak is the worst process's peak), timers pool count, total,
    min and max and recompute percentiles from the pooled reservoirs
    rather than averaging per-process quantiles.

    Returns a snapshot-shaped dict (series key → number, or a summary dict
    for timers)."""
    from keystone_tpu_torch.observe.metrics import percentiles

    acc: dict[str, dict] = {}
    for dump in dumps:
        for key, entry in (dump or {}).items():
            if not isinstance(entry, dict):
                continue
            kind = entry.get("kind", "counter")
            cur = acc.get(key)
            if cur is None:
                cur = dict(entry)
                if kind == "timer":
                    cur["samples"] = list(entry.get("samples") or [])
                acc[key] = cur
                continue
            if kind == "counter":
                cur["value"] = cur.get("value", 0) + entry.get("value", 0)
            elif kind == "gauge":
                cur["value"] = max(cur.get("value", 0.0), entry.get("value", 0.0))
            else:  # timer
                n_cur, n_new = cur.get("count", 0), entry.get("count", 0)
                cur["count"] = n_cur + n_new
                cur["total_s"] = cur.get("total_s", 0.0) + entry.get("total_s", 0.0)
                mins = [
                    d["min_s"]
                    for d, n in ((cur, n_cur), (entry, n_new))
                    if n and "min_s" in d
                ]
                if mins:
                    cur["min_s"] = min(mins)
                cur["max_s"] = max(cur.get("max_s", 0.0), entry.get("max_s", 0.0))
                cur["samples"].extend(entry.get("samples") or [])
    out: dict[str, object] = {}
    for key, entry in acc.items():
        if entry.get("kind") == "timer":
            samples = entry.pop("samples", [])
            entry.pop("kind", None)
            if entry.get("count"):
                entry["mean_s"] = entry["total_s"] / entry["count"]
            for pkey in ("p50_s", "p95_s", "p99_s"):
                entry.pop(pkey, None)
            if samples:
                p = percentiles(samples, (50, 95, 99))
                entry.update(p50_s=p[50], p95_s=p[95], p99_s=p[99])
            out[key] = entry
        else:
            out[key] = entry.get("value")
    return out


def _gather_dumps(payload: str, pid: int, nprocs: int, timeout_s: float) -> list[dict] | None:
    """Gather every process's serialized metrics dump onto process 0 over
    the group's store: each process sets its key, all meet at a barrier,
    process 0 reads every key, all meet at a second barrier, and process 0
    deletes the keys (after the last read: a long job rolling up
    periodically must not grow the store by one dump per process per
    call). Returns the dump list on process 0, None elsewhere and on a
    transport failure."""
    seq = next(_rollup_seq)
    try:
        g = _require_group()
        store, prefix = g.store, f"{g.prefix}metrics/{seq}/"
        store.set(f"{prefix}{pid}", payload)
        barrier(f"metrics_rollup_{seq}", timeout_s)
        dumps = None
        if pid == 0:
            dumps = [json.loads(store.get(f"{prefix}{i}")) for i in range(nprocs)]
        barrier(f"metrics_rollup_done_{seq}", timeout_s)
        if pid == 0:
            for i in range(nprocs):
                store.delete_key(f"{prefix}{i}")
        return dumps
    except Exception as e:  # noqa: BLE001 — degraded, never fatal
        logger.warning(
            "metrics roll-up over the coordinator's store failed (%r); each "
            "process keeps only its own metrics",
            e,
        )
        return None


def rollup_metrics(out_dir: str | None = None, timeout_s: float = 60.0) -> dict | None:
    """Cluster-wide metrics roll-up: every process serializes its metrics
    registry dump, process 0 gathers and merges them (counters summed,
    gauge watermarks maxed, timer reservoirs pooled), so a run report
    shows cluster totals instead of process 0's alone.

    Every process must call this (it meets at a barrier); the launcher
    does so after a ``--multihost`` pipeline returns. Process 0 writes
    ``metrics_cluster.json`` under ``out_dir`` (when given), emits a
    ``metrics_rollup`` event and returns the merged dict. Other processes
    return None. A transport failure degrades to a warning and None."""
    from keystone_tpu_torch.observe import events as _events
    from keystone_tpu_torch.observe import metrics as _metrics

    nprocs, pid = process_count(), process_index()
    local = {"process": pid, "metrics": _metrics.get_registry().dump()}
    if nprocs == 1:
        dumps: list[dict] | None = [local]
    else:
        from keystone_tpu_torch.observe import spans as _spans

        with _spans.span("multihost.rollup_gather", bucket="collective", hosts=nprocs):
            dumps = _gather_dumps(json.dumps(local), pid, nprocs, timeout_s)
        if dumps is None:
            return None
    merged = {
        "hosts": nprocs,
        "metrics": merge_metric_dumps([d.get("metrics", {}) for d in dumps]),
    }
    if out_dir:
        try:
            path = os.path.join(out_dir, CLUSTER_METRICS_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(merged, f, indent=1)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("cannot write %s under %s (%r)", CLUSTER_METRICS_FILE, out_dir, e)
    log = _events.active()
    if log is not None:
        log.emit("metrics_rollup", hosts=nprocs, series=len(merged["metrics"]))
    return merged
