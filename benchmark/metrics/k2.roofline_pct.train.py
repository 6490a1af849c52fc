"""``k2.roofline_pct.train``: K2's share of its roofline in the traced
train steps: per layer and step one causal bf16 forward over the whole
(batch, heads, seq, head dim), its need the larger of
``2 B h hd S (S + 1)`` operations at 989 TFLOP/s and q, k, v and the
output moved once at 3.35 TB/s; the time is K2's kernel in the device
trace."""

from benchmark.harness.readers import K2, roofline_pct


def read(rec):
    return roofline_pct(rec, "k2_train_bound_s", K2)
