"""``serve.slot_occupancy_pct``: the decode pool's fill, from the port's
counters over the window: ``DecodeLoop.occupancy_steps`` (active slots
summed over steps) over the pooled steps (``serve_decode_steps``) times
the slots. Under load offered at a fixed rate, a faster step retires
requests sooner and leaves the pool emptier, so lower is better."""


def read(rec):
    c = rec["counters"]
    if not c.get("steps") or not c.get("slots"):
        return None
    return 100.0 * c["occupancy_steps"] / (c["steps"] * c["slots"])
