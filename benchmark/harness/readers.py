"""What the per-layer readers share: the run record's spans, counters,
work counts and traced window, and the kernels' names in a trace.

Each reader returns ``None`` when it finds nothing to read; the harness
then leaves its metric out of the line. A share of a roofline or a peak
is never made up as 0.
"""

from __future__ import annotations

# the port's hand kernels as their names appear in a device trace
K1 = r"(^|[\s:])(gram_kernel|transpose_kernel)[<(]"
K2 = r"(^|[\s:])attention_kernel[<(]"
K4 = r"(^|[\s:])int8_matmul_kernel[<(]"


def span_mean_ms(rec: dict, name: str) -> float | None:
    spans = rec["spans"].get(name)
    return 1000.0 * sum(spans) / len(spans) if spans else None


def roofline_pct(rec: dict, bound_key: str, pattern: str) -> float | None:
    """The least time the work could take (``rec["work"][bound_key]``)
    over the device time of the kernels matching ``pattern`` in the
    traced window, in %."""
    tr, bound = rec.get("trace"), rec["work"].get(bound_key)
    if tr is None or not bound:
        return None
    seconds = tr.kernel_seconds(pattern)
    return 100.0 * bound / seconds if seconds > 0 else None


def idle_pct(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0 or tr.device_events == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
