"""``decode.mfu_pct``: the serving steps' share of the bf16 peak: the
model's work in the window (each prefill's ``2 P S`` plus causal
attention plus the last position's logits, each generated token's
``2 P`` plus attention over the positions it attends plus its logits)
over the seconds the window spent inside ``DecodeLoop.step`` and
989 TFLOP/s. The time between steps, when no request is in the pool, is
left out: it is the offered load's, not the step's."""

from benchmark.harness.peaks import BF16_FLOPS


def read(rec):
    w = rec["work"]
    if not w.get("step_s") or not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / w["step_s"] / BF16_FLOPS
