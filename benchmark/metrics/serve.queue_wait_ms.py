"""``serve.queue_wait_ms``: the mean time a request waits from when it
was due to the start of the step that admits it (host clock), over the
requests due in the window's untraced part: the decode loop's admission
wait, the part of time to first token that queueing adds."""


def read(rec):
    waits = rec["work"].get("admission_waits_s")
    return 1000.0 * sum(waits) / len(waits) if waits else None
