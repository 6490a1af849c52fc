"""``device_idle_pct.serve``: the share of the traced window in which no
kernel, copy or set ran on the card, in the serving cells."""

from benchmark.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
