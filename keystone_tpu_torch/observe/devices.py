"""Device-memory telemetry: per-device memory watermarks — port of
``keystone_tpu/observe/devices.py``.

``torch.cuda.memory_stats`` reports the caching allocator's current and
peak allocated bytes per card (``allocated_bytes.all.current`` /
``.peak``), and ``torch.cuda.mem_get_info`` the card's total. This module
samples them into the metrics registry (``hbm_bytes_in_use{device=...}`` /
``hbm_peak_bytes{device=...}`` gauges, the JAX package's names), tracks
the run-wide peak watermark per device, and emits rate-limited
``device_memory`` events so :mod:`.report` and ``observe top`` can render
where the high-water mark sits against the device's memory.

Degrade rule, as in the JAX package: a process without a card (the CPU)
yields an empty sample — no gauges, no events, no errors — so every
caller can sample unconditionally.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics

#: min seconds between samples taken via :meth:`DeviceMemoryMonitor.maybe_sample`
ENV_INTERVAL = "KEYSTONE_DEVMEM_INTERVAL_S"
_DEFAULT_INTERVAL_S = 5.0


def _device_stats(index: int) -> dict | None:
    """One card's allocator stats in the JAX package's key names, or None
    — split out so tests can fake a card's stats."""
    try:
        stats = torch.cuda.memory_stats(index)
    except Exception:  # noqa: BLE001 — no CUDA context
        return None
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", in_use)),
        "bytes_limit": int(torch.cuda.mem_get_info(index)[1]),
    }


def _device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def sample_device_memory() -> list[dict]:
    """One point-in-time sample: a dict per card (``[]`` without one)."""
    out: list[dict] = []
    for index in range(_device_count()):
        stats = _device_stats(index)
        if not stats:
            continue
        out.append(
            {
                "device": f"cuda:{index}",
                "kind": torch.cuda.get_device_name(index),
                "bytes_in_use": stats["bytes_in_use"],
                "peak_bytes_in_use": stats["peak_bytes_in_use"],
                "bytes_limit": stats["bytes_limit"],
            }
        )
    return out


def interval_s() -> float:
    try:
        return float(os.environ.get(ENV_INTERVAL, "") or _DEFAULT_INTERVAL_S)
    except ValueError:
        return _DEFAULT_INTERVAL_S


class DeviceMemoryMonitor:
    """Watermark tracker over repeated samples.

    ``sample()`` takes a sample NOW: updates the per-device gauges, the
    run-peak watermarks, and (rate-limited) emits a ``device_memory``
    event into the active sink. ``maybe_sample()`` is the per-step form:
    it samples at most once per interval and returns the current overall
    peak watermark either way (None without a card) — the train loop
    attaches that to its step records.
    """

    def __init__(self, emit_events: bool = True):
        self.watermarks: dict[str, int] = {}
        self.limits: dict[str, int] = {}
        self.emit_events = emit_events
        self._lock = threading.Lock()
        self._last_sample = 0.0
        self._last_event = 0.0

    def sample(self) -> list[dict]:
        samples = sample_device_memory()
        now = time.monotonic()
        reg = _metrics.get_registry()
        with self._lock:
            self._last_sample = now
            for s in samples:
                dev = s["device"]
                peak = max(self.watermarks.get(dev, 0), s["peak_bytes_in_use"], s["bytes_in_use"])
                self.watermarks[dev] = peak
                if s["bytes_limit"]:
                    self.limits[dev] = s["bytes_limit"]
                reg.gauge("hbm_bytes_in_use", device=dev).set(float(s["bytes_in_use"]))
                reg.gauge("hbm_peak_bytes", device=dev).set(float(peak))
            emit = self.emit_events and samples and now - self._last_event >= interval_s()
            if emit:
                self._last_event = now
        if emit:
            log = _events.active()
            if log is not None:
                log.emit("device_memory", devices=samples, peak_bytes=self.peak_bytes())
        return samples

    def maybe_sample(self) -> int | None:
        """Rate-limited sample (at most once per ``interval_s()``);
        returns the overall peak watermark in bytes, or None when no
        device reports stats."""
        with self._lock:
            due = time.monotonic() - self._last_sample >= interval_s() or not self._last_sample
        if due:
            self.sample()
        return self.peak_bytes()

    def peak_bytes(self) -> int | None:
        """Highest watermark across devices so far (None: no stats)."""
        with self._lock:
            return max(self.watermarks.values()) if self.watermarks else None
