"""``fit.stream_ms``: mean milliseconds a fit spends in the stage that the
benchmark's ``fit.stream`` span wraps (host clock, the card synchronised at
the span's end), over every fit of the traced run's window."""

from benchmark.harness.readers import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "fit.stream")
