"""``k2.roofline_pct.serve``: K2's share of its roofline in the traced
window's prefills: per layer and prefill one causal bf16 call over the
prompt's own tokens (the bucket's padding is not needed work), its need
the larger of ``2 h hd S (S + 1)`` operations at 989 TFLOP/s and q, k, v
and the output moved once at 3.35 TB/s; the time is K2's kernel in the
device trace."""

from benchmark.harness.readers import K2, roofline_pct


def read(rec):
    return roofline_pct(rec, "k2_prefill_bound_s", K2)
