"""``k4.roofline_pct``: K4's share of its roofline in the traced steps.
Each call's need is the larger of its operations (``2 m k n``) at the
bf16 peak and its bytes (the int8 codes and f32 scales read once, the
bf16 rows read and written once) at 3.35 TB/s. Which products K4 served
is read from the trace: its launches, over the launches of one set of
block products (every layer's), give the number of sets it served, to
the nearest whole; the program sends the narrowest products to K4, so
these are the narrowest of the window's candidate sets (its pooled steps
and prefills). The profiler can drop records, so the need is that of
those sets per launch, times the launches counted; the time is K4's
kernel in the device trace."""

from benchmark.harness.readers import K4


def read(rec):
    tr, w = rec.get("trace"), rec["work"]
    calls, per = w.get("k4_calls"), w.get("k4_launches_per_call")
    if tr is None or not calls or not per:
        return None
    launches, seconds = tr.kernel_count(K4), tr.kernel_seconds(K4)
    if not launches or seconds <= 0:
        return None
    sets = min(max(round(launches / per), 1), len(calls))
    need = sum(bound for _, bound in sorted(calls)[:sets]) * launches / (sets * per)
    return 100.0 * need / seconds
