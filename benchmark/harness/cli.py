"""One run of one cell: set the environment, check the card, hand the cell
to its driver, read the per-layer metrics, check that no JAX module was
loaded, and print the result line.

A cell's module in ``benchmark/drivers/`` (named by the traffic mix)
exposes ``run(run: Run)``. It builds the system under test from the
configuration and the seed, warms it, calls ``run.start_window()`` just
before its first timed unit of work, measures for ``run.seconds``, reads
``run.read_memory_peak()`` once the window has closed, frees the
program's state, and judges what the window produced against the plain
reference with ``run.check(...)``. It fills ``run.metrics`` with the
end-to-end metrics and ``run.record`` with what the per-layer readers
read.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

from benchmark.harness import spec as _spec

FORBIDDEN = ("jax", "jaxlib", "flax", "keystone_tpu")
CACHE_DIR = ".bench_cache"


class Run:
    """What a driver is given, and what it hands back."""

    def __init__(self, cell: _spec.Cell, seed: int, seconds: float, trace: bool,
                 root: str, t_process: float, device: str = "cuda"):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.root = root
        self.t_process = t_process
        self.device = device
        self.t_window: float | None = None
        self.metrics: dict = {}
        self.record: dict = {"spans": {}, "counters": {}, "work": {}, "trace": None}
        self.checks: list = []
        self.control_checks: list = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        # set by the readings tool: the cell's module also judges the control
        # (the reference in the next lower precision) with check_control
        self.control = False

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.params

    @property
    def limits(self) -> dict:
        """The cell's limits on the numbers compared
        (``benchmark/limits/<cell>.json``)."""
        return self.cell.limits

    @property
    def trace_path(self) -> str:
        return os.path.join(self.root, CACHE_DIR, "trace", "window.json")

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def start_window(self) -> float:
        """Mark the start of the first timed unit: set-up ends here."""
        self.t_window = time.perf_counter()
        self.metrics["setup_s"] = self.t_window - self.t_process
        return self.t_window

    def span(self, name: str, seconds: float) -> None:
        self.record["spans"].setdefault(name, []).append(float(seconds))

    def read_memory_peak(self) -> int:
        """The allocator's peak on the fullest card used, read once the
        window has closed and before the reference runs."""
        import torch

        if self.device == "cuda":
            self.memory_peak_bytes = max(
                torch.cuda.max_memory_allocated(i) for i in range(self.cell.chips)
            )
        return self.memory_peak_bytes

    def check(self, name: str, value: float, limit: float) -> bool:
        """Record one compared number with its limit; it passes when it
        is a number at or below the limit."""
        self.checks.append(_judged(name, value, limit))
        return self.checks[-1][-1]

    def check_control(self, name: str, value: float) -> None:
        """Judge the control's reading of a compared number as
        :meth:`check` judges the program's, against the cell's limit; kept
        apart from the run's own checks."""
        self.control_checks.append(_judged(name, value, self.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(ok for *_, ok in self.checks) and self.failed == 0

    @property
    def control_correct(self) -> bool | None:
        """Whether the control, in the program's place, would pass every
        limit (None where no control was read)."""
        if not self.control_checks:
            return None
        return all(ok for *_, ok in self.control_checks)


def _judged(name: str, value, limit: float) -> tuple:
    """(name, value, limit, passes): a number passes at or below its limit."""
    value = float(value) if value is not None else math.nan
    return name, value, float(limit), math.isfinite(value) and value <= limit


def prepare_environment(root: str) -> None:
    """Fixed cache directories inside the checkout, the port's knobs at
    their defaults, and no JAX behind any library. Runs before torch is
    imported."""
    cache = os.path.join(root, CACHE_DIR)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    for var in list(os.environ):
        if var.startswith(("KEYSTONE_", "KST_")):
            del os.environ[var]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: ``sys.modules``) that
    a run must not load, each compared whole: ``keystone_tpu_torch`` is
    not ``keystone_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_reader(root: str, metric: str):
    """The ``read(record)`` function of ``benchmark/metrics/<metric>.py``."""
    path = _spec.metric_path(root, metric)
    mod_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it: a roofline share
    is stated with it beside it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0].strip() if out else "unknown"


def execute(run: Run) -> dict:
    """Drive the cell and assemble the result line's object."""
    driver = importlib.import_module(f"benchmark.drivers.{run.cell.driver}")
    driver.run(run)
    tr = run.record.get("trace")
    if run.trace and run.device == "cuda" and (tr is None or tr.busy_s <= 0):
        raise RuntimeError("the traced window holds no device record: no device metric to read")
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed}
    if run.trace:
        rec = run.record
        metrics = {}
        for m in run.cell.per_layer:
            value = load_reader(run.root, m.name)(rec)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
        out["metrics"] = metrics
    else:
        out["metrics"] = {
            m.name: {"value": float(run.metrics[m.name]), "unit": m.unit}
            for m in run.cell.end_to_end
        }
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": run.record.get("device_kind", run.device),
              "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["device"] = device
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in run.checks}
    return out


def main(argv: list, root: str, t_process: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare_environment(root)
    cell = _spec.load_cell(root, args.workload)
    import torch

    import keystone_tpu_torch  # noqa: F401 — the system under test must be there

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2

    run = Run(cell, args.seed, args.seconds, bool(args.trace), root, t_process)
    run.record["device_kind"] = torch.cuda.get_device_name(0)
    run.log(f"card {run.record['device_kind']}, power limit {power_limit()}, "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"modules that the run must not load were loaded: {bad}", file=sys.stderr)
        return 3
    for name, value, limit, ok in run.checks:
        print(f"check {name}: {value!r} (limit {limit!r}) {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
