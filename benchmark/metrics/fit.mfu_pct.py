"""``fit.mfu_pct``: the whole fit's share of the card's peaks: the sum
over its stages of the work the configuration needs at its dtype's peak
(the int8 Gram at 1,979 TOP/s; the FFT featurizer, the cross product and
the solve in float32 at 67 TFLOP/s), over the mean wall of a fit in the
window."""


def read(rec):
    w = rec["work"]
    walls = w.get("fit_walls_s")
    if not walls or not w.get("fit_bound_s"):
        return None
    return 100.0 * w["fit_bound_s"] / (sum(walls) / len(walls))
