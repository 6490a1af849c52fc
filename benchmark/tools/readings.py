"""Run a cell's driver many times in one process: the numbers that
``correct`` compares, over many seeds, with the control's beside them;
or a serving mix at several offered rates, to find its knee once.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 --seconds 5 [--control]
    python3 benchmark/tools/readings.py --workload gpt2m_decode --seeds 1 --rates 5,6,7,8 --seconds 30

Each run is a whole run of the cell's driver at the cell's own sizes
(set-up, a window of ``--seconds``, the check), in this process, so the
CUDA context and the kernels load once. ``--control`` also reads the
control: the reference put in the program's place in the next lower
precision (``control_*`` in the traffic mix). ``--fault`` plants one of
``benchmark/tests/test_harness_faults.py``'s faults under the timed path.
``--rates`` replaces the mix's ``rate_per_s``: the knee is the highest
rate whose backlog does not grow, and a serving cell is fixed at about
four fifths of it. One JSON line a run; the benchmark's own runs never
run the control, a fault or a sweep.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from benchmark.harness import cli, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None, help="a fault's function name, e.g. _train_half_batch")
    ap.add_argument("--rates", default=None, help="offered rates (requests/s) of a serving mix")
    args = ap.parse_args(argv)
    cli.prepare_environment(ROOT)
    base = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        from benchmark.tests import test_harness_faults

        getattr(test_harness_faults, args.fault)(_Patch())
    rates = [float(r) for r in args.rates.split(",")] if args.rates else [None]
    for rate in rates:
        cell = copy.deepcopy(base)
        if rate is not None:
            cell.params["rate_per_s"] = rate
        for seed in (int(s) for s in args.seeds.split(",")):
            run = cli.Run(cell, seed, args.seconds, False, ROOT, time.perf_counter())
            run.control = args.control
            run.record["device_kind"] = torch.cuda.get_device_name(0)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = cli.execute(run)
            line = {"seed": seed, "correct": out["correct"], "checks": out["checks"],
                    "control": {n: v for n, v, *_ in run.control_checks} or None,
                    "control_correct": run.control_correct, "metrics": out["metrics"],
                    "memory_peak_bytes": run.memory_peak_bytes,
                    "check_s": run.record.get("check_s"), "wall_s": time.perf_counter() - t0}
            if rate is not None:
                w, c = run.record["work"], run.record["counters"]
                line.update(rate_per_s=rate, tokens_per_s=w["tokens"] / w["window_s"],
                            backlog=w["backlog"], requests=w["requests"],
                            occupancy_pct=100.0 * c["occupancy_steps"]
                            / max(1, c["steps"] * c["slots"]))
            print(json.dumps(line), flush=True)
            del run
            torch.cuda.empty_cache()
    return 0


class _Patch:
    """The one ``monkeypatch`` call the faults make, for the whole process."""

    @staticmethod
    def setattr(obj, name, value):
        setattr(obj, name, value)


if __name__ == "__main__":
    sys.exit(main())
