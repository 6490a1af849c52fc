"""``device_idle_pct.fit``: the share of the traced window in which no
kernel, copy or set ran on the card, in the fit cells."""

from benchmark.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
