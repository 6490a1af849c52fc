"""Tracing / profiling hooks — port of ``keystone_tpu/core/profiling.py``.

- :func:`trace` — capture a ``torch.profiler`` trace (CPU and, with a
  card, CUDA activity) around a code block and write it as a Chrome
  trace (``trace.json`` under the directory; open it in Perfetto or
  ``chrome://tracing``),
- :func:`annotate` — name a region so it shows up in the trace timeline
  (``torch.profiler.record_function``),
- :func:`log_time` (re-exported from core.logging) — wall-clock brackets.

``KEYSTONE_TRACE_DIR`` gates :func:`trace`: unset, the explicit
``log_dir`` argument is used; set to a path, it is the default directory
when no ``log_dir`` is passed; set to ``""``/``"0"``/``"off"``/``"none"``,
tracing is a no-op even when a directory is passed (the production kill
switch). A profiler that fails to start or to write degrades to one
warning and an unprofiled run, as in the JAX package; :func:`trace`
yields the file it will write (or None), so a caller that must have the
trace can check for it.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

from keystone_tpu_torch.core.logging import get_logger, log_time  # noqa: F401

logger = get_logger("keystone_tpu_torch.profiling")

ENV_TRACE_DIR = "KEYSTONE_TRACE_DIR"
_DISABLED_VALUES = ("", "0", "off", "none")
TRACE_FILE = "trace.json"


def _effective_trace_dir(log_dir: str | None) -> str | None:
    env = os.environ.get(ENV_TRACE_DIR)
    if env is not None and env.lower() in _DISABLED_VALUES:
        return None  # explicit kill switch beats any argument
    if log_dir:
        return log_dir
    return env or None


def activities() -> list:
    """The profiler activities of this process: the CPU, and CUDA when a
    card is visible."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


# The first device records of a session on the card can come back stamped
# before the session began, and the profiler then drops them as out of its
# window (on an H100 with torch 2.11 and CUDA 12.8: always the first ones,
# whatever the idle time before them, more of them the more sessions the
# process has run). A session with CUDA activity therefore starts with
# PRIMER_OPS one-element adds inside the PRIMER_REGION annotation, whose
# records take that loss; audit_trace says whether any record past them
# was lost all the same.
PRIMER_REGION = "keystone.profiler_primer"
PRIMER_OPS = 1024

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_API_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CALLS = ("Launch", "Memcpy", "Memset")


def _cuda_session(prof) -> bool:
    return torch.profiler.ProfilerActivity.CUDA in (prof.activities or ())


def prime() -> None:
    """Run the primer inside an open session with CUDA activity (see
    ``PRIMER_OPS``); the card is idle when it returns."""
    torch.cuda.synchronize()
    with torch.profiler.record_function(PRIMER_REGION):
        x = torch.zeros(1, device="cuda")
        for _ in range(PRIMER_OPS):
            x.add_(1)
        torch.cuda.synchronize()


def start_profiler(path: str):
    """Start a ``torch.profiler`` session that will write ``path``, primed
    on the card (see ``PRIMER_OPS``); returns the session (raises if it
    cannot start)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof = torch.profiler.profile(activities=activities())
    prof.__enter__()
    if _cuda_session(prof):
        prime()
    return prof


def stop_profiler(prof, path: str) -> None:
    """Stop ``prof`` (once the card's queued work has run) and export its
    Chrome trace to ``path``."""
    if _cuda_session(prof):
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)


def _spans(events, match) -> dict:
    """``{tid: [(begin, end), ...]}`` of the events ``match`` accepts."""
    out: dict = {}
    for e in events:
        if match(e):
            out.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    return out


def _within(spans, e) -> bool:
    return any(b <= e["ts"] <= end for b, end in spans.get(e.get("tid"), ()))


def audit_trace(path: str) -> dict:
    """Read a Chrome trace of a session with CUDA activity: every call that
    puts work on the card (a launch, a copy, a set) outside a stream
    capture should have a device record with its correlation id.
    Returns ``device_events`` (device records past the primer), ``lost``
    (such calls past the primer without one) and ``primer_lost`` (the
    primer's own)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    api = [e for e in events if e.get("cat") in _API_CATS and "ts" in e]
    begins = sorted((e for e in api if "BeginCapture" in e.get("name", "")), key=lambda e: e["ts"])
    ends = sorted((e for e in api if "EndCapture" in e.get("name", "")), key=lambda e: e["ts"])
    capture: dict = {}
    for b in begins:
        end = next((e["ts"] for e in ends if e.get("tid") == b.get("tid") and e["ts"] >= b["ts"]),
                   float("inf"))
        capture.setdefault(b.get("tid"), []).append((b["ts"], end))
    primer = _spans(events, lambda e: e.get("cat") == "user_annotation"
                    and e.get("name") == PRIMER_REGION)
    seen = {e.get("args", {}).get("correlation") for e in device}
    primer_ids = set()
    lost = primer_lost = 0
    for e in api:
        name = e.get("name", "")
        if not any(w in name for w in _DEVICE_CALLS) or "HostFunc" in name or _within(capture, e):
            continue
        corr = e.get("args", {}).get("correlation")
        in_primer = _within(primer, e)
        if in_primer:
            primer_ids.add(corr)
        if corr in seen:
            continue
        if in_primer:
            primer_lost += 1
        else:
            lost += 1
    work = sum(1 for e in device if e.get("args", {}).get("correlation") not in primer_ids)
    return {"device_events": work, "lost": lost, "primer_lost": primer_lost,
            "all_device_events": len(device)}


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block into ``<log_dir>/trace.json``.

    Degrades instead of aborting: a profiler that cannot start or write
    logs a warning and the block runs unprofiled. A no-op when gated off
    (module docstring) or when no directory is configured. Yields the
    trace file's path, or None when nothing will be written."""
    log_dir = _effective_trace_dir(log_dir)
    if log_dir is None:
        yield None
        return
    path = os.path.join(log_dir, TRACE_FILE)
    prof = None
    try:
        prof = start_profiler(path)
    except Exception as e:  # noqa: BLE001 — degrade, don't abort the run
        logger.warning("profiler trace to %s unavailable (%r); running unprofiled", log_dir, e)
    try:
        yield path if prof is not None else None
    finally:
        if prof is not None:
            try:
                stop_profiler(prof, path)
                logger.info("profile written to %s", path)
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler stop failed: %r", e)


def annotate(name: str):
    """Named region in profiler timelines (the RDD.setName analog)."""
    return torch.profiler.record_function(name)
