"""``train.mfu_pct``: the train step's share of the bf16 peak: the port's
own count of a step's work (``6 P tokens + 12 L d S² B``, copied into
``benchmark/work/lm.py``) times the window's steps, over the window's
seconds and 989 TFLOP/s."""

from benchmark.harness.peaks import BF16_FLOPS


def read(rec):
    w = rec["work"]
    if not w.get("window_s") or not w.get("steps") or not w.get("step_flops"):
        return None
    return 100.0 * w["step_flops"] * w["steps"] / w["window_s"] / BF16_FLOPS
