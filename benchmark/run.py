#!/usr/bin/env python3
"""The benchmark of ``keystone_tpu_torch`` on NVIDIA cards: one run of one
cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout that holds the port. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its
limit). ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer ones. Without a card, or with fewer cards than the
cell asks for, it exits 2 and prints no result.
"""

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (the interpreter's own start
    included), from ``/proc``; 0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS_START = time.perf_counter() - _process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark.harness.cli import main

    sys.exit(main(sys.argv[1:], ROOT, T_PROCESS_START))
