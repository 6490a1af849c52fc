"""The traced window: one ``torch.profiler`` session on the card, read
back from its Chrome trace.

A session's first device records can come back stamped before the
session began, and the profiler then drops them. So the session opens
with a primer of one-element adds, which takes that loss, and only then
starts the window (the ``bench.window`` annotation). From the trace the
window gives:

- ``window_s``: the window's length, from its annotation;
- ``busy_s``: the seconds in which a kernel, copy or set ran on the card
  within the window (overlaps counted once);
- device time by kernel name, for the rooflines;
- the longest idle gaps, each named by the innermost of the benchmark's
  annotations that was open on the host in the middle of the gap.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time

WINDOW = "bench.window"
PRIMER = "bench.primer"
PRIMER_OPS = 1024
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """A parsed traced window (see the module docstring)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not win:
            raise ValueError("the trace holds no bench.window annotation")
        w = max(win, key=lambda e: e.get("dur", 0))
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0))
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.device = [
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
            for e in events
            if e.get("cat") in DEVICE_CATS and "ts" in e
            and self.t0 <= float(e["ts"]) < self.t1
        ]
        self.spans = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
            for e in events
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("bench.")
            and e.get("name") not in (WINDOW, PRIMER)
        )
        self.busy = _union(sorted((b, min(e, self.t1)) for b, e, _ in self.device))
        self.busy_s = sum(e - b for b, e in self.busy) * 1e-6

    @property
    def device_events(self) -> int:
        return len(self.device)

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the window's events whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - b for b, e, n in self.device if rx.search(n)) * 1e-6

    def kernel_count(self, pattern: str) -> int:
        """The window's device events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(1 for _, _, n in self.device if rx.search(n))

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time: [name, s]."""
        by: dict = {}
        for b, e, n in self.device:
            by[n] = by.get(n, 0.0) + (e - b) * 1e-6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), s] for n, s in top]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time on the card by what the host was doing: the window's
        gaps between busy intervals (and before the first and after the
        last), summed by the innermost ``bench.*`` annotation open at each
        gap's middle; the ``k`` largest: [name, s]."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        by: dict = {}
        for i in range(0, len(edges), 2):
            b, e = edges[i], edges[i + 1]
            if e <= b:
                continue
            mid = 0.5 * (b + e)
            open_ = [s for s in self.spans if s[0] <= mid <= s[1]]
            label = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "host outside the benchmark's spans"
            by[label] = by.get(label, 0.0) + (e - b) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


def _union(intervals: list) -> list:
    out: list = []
    for b, e in intervals:
        if out and b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return out


def annotate(name: str):
    """A host span in the trace (a no-op outside a profiler session)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def traced_window(path: str, holder: dict):
    """Profile the enclosed block on the card; on exit ``holder["trace"]``
    is its :class:`DeviceTrace` and ``holder["overhead_s"]`` the host
    seconds that opening the session (the primer; ``holder["opened_s"]``,
    set when the block starts) and closing it (stopping the profiler,
    writing, reading and deleting the Chrome trace at ``path``, a fixed
    file inside the checkout) took: a driver leaves them out of its
    window."""
    import torch

    t0 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        torch.cuda.synchronize()
        with torch.profiler.record_function(PRIMER):
            x = torch.zeros(1, device="cuda")
            for _ in range(PRIMER_OPS):
                x.add_(1)
            torch.cuda.synchronize()
        opened = time.perf_counter() - t0
        holder["opened_s"] = opened
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    finally:
        t1 = time.perf_counter()
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    holder["trace"] = DeviceTrace(events)
    holder["overhead_s"] = opened + time.perf_counter() - t1
