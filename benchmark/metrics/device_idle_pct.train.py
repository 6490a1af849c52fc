"""``device_idle_pct.train``: the share of the traced window in which no
kernel, copy or set ran on the card, in the training cells."""

from benchmark.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
