"""The harness against its contract, on the CPU: the result line's keys,
the names and units of ``BENCHMARK.json``, the modules a run loads, a
cell added from files alone, and the traced window's arithmetic."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import cli, spec
from benchmark.harness.trace import DeviceTrace
from benchmark.tests import contract, tiny

ROOT = tiny.ROOT


def test_benchmark_json_keeps_the_contract():
    bench = spec.load_benchmark(ROOT)
    assert contract.problems(bench, ROOT) == []
    raw = open(os.path.join(ROOT, "BENCHMARK.json"), "rb").read()
    assert len(raw) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"], bench)
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m.moves in names, (w["name"], m.name)


@pytest.mark.parametrize("name,ok", [
    ("gpt2m_decode", True), ("k2.roofline_pct.serve", True), ("_x-1.y", True),
    ("a" * 64, True), ("a" * 65, False), ("has space", False), ("a,b", False),
    ("a/b", False), ("-lead", False), (".lead", False), ("µs", False), ("", False),
])
def test_names(name, ok):
    assert bool(contract.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("tokens/s", True), ("%", True), ("ms", True), ("rows/s", True), ("us", True),
    ("tokens per second", False), ("µs", False), ("a" * 17, False), ("", False),
])
def test_units(unit, ok):
    assert bool(contract.UNIT.match(unit)) is ok


def test_problems_finds_a_broken_entry():
    bench = spec.load_benchmark(ROOT)
    bench["end_to_end"][0]["bound"] = 0.3
    bench["per_layer"][0]["why"] = "not a key a metric may have"
    bench["workloads"][0]["name"] = "has space"
    found = " ".join(contract.problems(bench))
    assert "bound" in found and "keys" in found and "bad name" in found


def test_result_line_keys_untraced():
    out, run = tiny.execute(tiny.fit_cell())
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert "breakdown" not in out
    assert set(out["metrics"]) == {"fit_rows_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"]["fit_pred_err"]["limit"] == 0.3
    json.dumps(out)


def test_result_line_keys_traced(monkeypatch):
    """A traced run carries the per-layer metrics, ``busy_s`` and
    ``window_s`` and the breakdown; here a synthetic trace stands in for
    the profiler's, which needs a card."""
    cell = tiny.fit_cell()
    out, run = tiny.execute(cell, trace=True)
    assert set(out["metrics"]) == {"fit.plan_ms", "fit.stream_ms", "fit.solve_ms", "fit.mfu_pct"}
    assert "breakdown" not in out  # no device trace on the CPU
    run.record["trace"] = DeviceTrace(_events())
    monkeypatch.setitem(sys.modules, "benchmark.drivers.replay", _Replay(run))
    monkeypatch.setitem(run.cell.traffic, "driver", "replay")
    out = cli.execute(run)
    assert list(out)[-1] == "checks"
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["busy_s"] == pytest.approx(0.003)
    assert out["device"]["window_s"] == pytest.approx(0.010)


class _Replay:
    """A driver that hands back a run already made."""

    def __init__(self, done):
        self.done = done

    def run(self, run):
        run.__dict__.update(self.done.__dict__)


def _events():
    ann = "user_annotation"
    return [
        {"cat": ann, "name": "bench.primer", "ts": 0, "dur": 500},
        {"cat": ann, "name": "bench.window", "ts": 1000, "dur": 10000},
        {"cat": ann, "name": "bench.plan", "ts": 1000, "dur": 4000},
        {"cat": ann, "name": "bench.stream", "ts": 5000, "dur": 6000},
        {"cat": "kernel", "name": "void gram_kernel(CUtensorMap_st, float*)", "ts": 5000, "dur": 2000},
        {"cat": "kernel", "name": "elementwise", "ts": 6500, "dur": 1000},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 9000, "dur": 500},
        {"cat": "kernel", "name": "primer add", "ts": 100, "dur": 10},
    ]


def test_device_trace_arithmetic():
    tr = DeviceTrace(_events())
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.003)  # [5000, 7500] and [9000, 9500]
    assert tr.device_events == 3
    from benchmark.harness.readers import K1

    assert tr.kernel_seconds(K1) == pytest.approx(0.002)
    assert tr.top_ops(2) == [["void gram_kernel(CUtensorMap_st, float*)", pytest.approx(0.002)],
                             ["elementwise", pytest.approx(0.001)]]
    gaps = dict(tr.idle_gaps())
    assert gaps["bench.plan"] == pytest.approx(0.004)
    assert gaps["bench.stream"] == pytest.approx(0.003)


@pytest.mark.parametrize("names,found", [
    (["keystone_tpu_torch", "keystone_tpu_torch.models.lm", "torch", "benchmark.run"], []),
    (["keystone_tpu_torch", "keystone_tpu.ops"], ["keystone_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen", "jaxtyping"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_compares_whole_top_level_names(names, found):
    assert cli.forbidden_modules(names) == found


def test_a_run_loads_no_jax_and_not_the_jax_package():
    """A whole fit run and a whole decode run in a fresh process, past the
    look for a card: no module whose top-level name is ``jax``,
    ``jaxlib``, ``flax`` or ``keystone_tpu`` is loaded, while
    ``keystone_tpu_torch`` is."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.tests import tiny\n"
        "tiny.execute(tiny.fit_cell(), seconds=0.5)\n"
        "tiny.execute(tiny.decode_cell(), seconds=0.5)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "keystone_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "keystone_tpu"}, sorted(top)


def test_run_exits_without_a_card_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mnist_fit", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_fails_in_a_checkout_without_the_program(tmp_path):
    """Only ``BENCHMARK.json`` and the benchmark's own files: no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mnist_fit", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "keystone_tpu_torch" in proc.stderr


def test_a_cell_is_added_from_files_alone(tmp_path):
    """A new configuration, traffic mix, limits file and per-layer metric,
    each a new file, and new entries in ``BENCHMARK.json``: the harness
    finds them by name, and no file that was there changes."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "keystone_tpu_torch"), tmp_path / "keystone_tpu_torch")
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = spec.load_benchmark(ROOT)

    cfg = tiny.fit_cell().config
    (bench_dir / "configs" / "mnist_tiny.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "fits_short.json").write_text(json.dumps(
        {"driver": "fit", "params": {"warm_fits": 1, "trace_fits": 1, "control_gram_bits": 4, "control_feature_bits": 10}}))
    (bench_dir / "limits" / "mnist_tiny_fit.json").write_text(json.dumps({"fit_pred_err": 0.3, "fit_mean_err": 1e-3}))
    (bench_dir / "metrics" / "fit.count.py").write_text(
        "def read(rec):\n    return rec['work'].get('fits')\n")
    bench["configs"].append({"name": "mnist_tiny", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/mnist_tiny.json",
                             "reduced": ["numFFTs"], "why": "a test"})
    bench["workloads"].append({"name": "mnist_tiny_fit", "config": "mnist_tiny",
                               "traffic": "fits_short", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "fit_rows_per_s":
            m["workloads"].append("mnist_tiny_fit")
    bench["per_layer"].append({"name": "fit.count", "unit": "fits", "better": "higher",
                               "source": "host_clock", "layer": "the whole fit",
                               "moves": "fit_rows_per_s", "workloads": ["mnist_tiny_fit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    assert contract.problems(bench, str(tmp_path)) == []
    cell = spec.load_cell(str(tmp_path), "mnist_tiny_fit")
    assert [m.name for m in cell.per_layer] == ["fit.count"]
    run = cli.Run(cell, 5, 0.5, True, str(tmp_path), 0.0, device="cpu")
    cli.prepare_environment(str(tmp_path))
    out = cli.execute(run)
    assert out["metrics"]["fit.count"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before
