"""``k1.roofline_pct``: K1's share of its roofline in the traced fits. The
need of each call is its chunk's valid rows' ``rows · D (D + 1)`` int8
operations against 1,979 TOP/s, or its bytes (codes read once, the f32
Gram written once) against 3.35 TB/s, whichever is larger; the time is
K1's kernels (its transpose and its Gram) in the device trace."""

from benchmark.harness.readers import K1, roofline_pct


def read(rec):
    return roofline_pct(rec, "k1_bound_s", K1)
