"""keystone_tpu_torch's observability tools against the JAX package's, on
the CPU: the run report, ``observe top --once`` and the fleet dashboard
render the same text from the same run directory (one the port's writers
made: a planned MNIST run and a few LM train steps); cost profiles count
a gemm node's FLOPs as XLA's ``cost_analysis`` does and a K1 node's as its
wrapper's N·D·(D+1) with the plain version running; the step tracer writes
one trace per window and records an empty window as empty and a window
whose trace lost device records as incomplete; the device
monitor degrades without a card as the JAX package's does, and tracks a
card's watermark the same way; ``instrument`` records nothing but a
capture count under a CUDA graph capture; ``core/profiling.trace`` honors
its kill switch; and the ``python -m keystone_tpu_torch`` launcher."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.core.pipeline import transformer as j_transformer  # noqa: E402
from keystone_tpu.observe import cost as j_cost  # noqa: E402
from keystone_tpu.observe import dashboard as j_dashboard  # noqa: E402
from keystone_tpu.observe import devices as j_devices  # noqa: E402
from keystone_tpu.observe import report as j_report  # noqa: E402
from keystone_tpu.observe import top as j_top  # noqa: E402
from keystone_tpu_torch.core import profiling  # noqa: E402
from keystone_tpu_torch.core.pipeline import Pipeline, transformer  # noqa: E402
from keystone_tpu_torch.observe import collector, dashboard, devices, events  # noqa: E402
from keystone_tpu_torch.observe import cost, instrument, metrics, report, top, tracing  # noqa: E402
from keystone_tpu_torch.ops import gram  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(*args, env=None, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout, env=dict(os.environ, **(env or {})),
    )


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """One observed run made by the port's writers: the MNIST model under
    the planner through the launcher (per-node events, planner and staging
    decisions, phases, cost profiles), then four LM train steps in the
    same base directory (steps.jsonl)."""
    base = tmp_path_factory.mktemp("obs")
    run = _launch("--observe", str(base), "mnist-random-fft", "--synthetic", "600",
                  "--num-ffts", "1", "--block-size", "512", "--device", "cpu",
                  env={"KEYSTONE_PLAN": "1"})
    assert run.returncode == 0, run.stderr[-2000:]
    (mnist_dir,) = [os.path.join(base, d) for d in os.listdir(base)]
    from keystone_tpu_torch.models.lm import TransformerLM, synthetic_corpus, train

    lm = TransformerLM.create(vocab=32, max_seq=16, dim=16, depth=1, num_heads=2, device="cpu")
    with events.run(str(base / "lm")) as log:
        train(lm, synthetic_corpus(300, 32), steps=4, batch=2, seq=8)
    return mnist_dir, log.run_dir


def _without_profiles(path):
    """The run's files less ``cost_profiles.json``: the two packages' peak
    tables name different devices, so the profile columns are compared
    apart (``test_report_profile_columns``)."""
    os.replace(os.path.join(path, cost.COST_FILE), os.path.join(path, "profiles.bak"))
    return path


def _restore_profiles(path):
    os.replace(os.path.join(path, "profiles.bak"), os.path.join(path, cost.COST_FILE))


def test_report_renders_the_jax_packages_text(run_dir):
    mnist_dir, lm_dir = run_dir
    for path in (mnist_dir, lm_dir):
        if os.path.exists(os.path.join(path, cost.COST_FILE)):
            _without_profiles(path)
            try:
                got, want = report.render(path), j_report.render(path)
            finally:
                _restore_profiles(path)
        else:
            got, want = report.render(path), j_report.render(path)
        # the usage hints name each package's own launcher
        assert got.replace("keystone_tpu_torch", "keystone_tpu") == want
    text = report.render(mnist_dir)
    assert "optimizer decisions" in text and "phases:" in text
    assert "00:FeaturizerBank" in text


def test_report_profile_columns(run_dir):
    """The port's profiles are joined the JAX way; off the card the bytes
    column reads ``-`` and the report says why."""
    mnist_dir, _ = run_dir
    profiles = cost.load_profiles(mnist_dir)
    assert profiles["device_kind"] == "cpu"
    assert set(profiles["profiles"]) == {"00:FeaturizerBank", "01:BlockLinearMapper",
                                         "02:MaxClassifier"}
    assert profiles["profiles"]["01:BlockLinearMapper"]["flops"] > 0
    text = report.render(mnist_dir)
    assert "MB_acc not measured" in text
    assert "MB_acc not measured" not in j_report.render(mnist_dir)


def test_top_once_renders_the_jax_packages_text(run_dir, monkeypatch, capsys):
    monkeypatch.setattr(time, "time", lambda: 2e9)
    for path in run_dir:
        top.main([path, "--once"])
        got = capsys.readouterr().out
        j_top.main([path, "--once"])
        assert got == capsys.readouterr().out
    assert "steps" in got.lower()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def test_dashboard_serves_the_jax_packages_answers(run_dir, tmp_path, capsys):
    """A collector cycle over the run dirs, then both dashboards on the
    same store: series, SLO verdicts, the page and the summary agree."""
    out = tmp_path / "collector"
    collector.main([str(out), "--watch", os.path.dirname(run_dir[0]), "--once"])
    capsys.readouterr()
    answers = []
    for mod in (dashboard, j_dashboard):
        httpd = mod.serve(str(out), port=0)
        thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05})
        thread.start()
        try:
            port = httpd.server_address[1]
            summary = json.loads(_get(port, "/api/summary"))
            summary.pop("ts")
            answers.append([_get(port, "/api/series"), _get(port, "/api/slo"),
                            _get(port, "/"), _get(port, "/metrics"), summary])
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(5)
    assert answers[0] == answers[1]
    assert json.loads(answers[0][0])["series"]


# ----------------------------------------------------------------- cost


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (2048, 784, 10)])
def test_gemm_node_flops_equal_xla_cost_analysis(m, k, n):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    got = cost.analyze(lambda node, b: node(b), transformer(lambda b: b @ tw, name="mm"),
                       torch.from_numpy(x))
    want = j_cost.analyze(lambda node, b: node(b), j_transformer(lambda b: b @ jw, name="mm"),
                          jnp.asarray(x))
    assert got["flops"] == want["flops"] == 2.0 * m * k * n
    assert got["argument_bytes"] == x.nbytes  # the weights ride in the closure
    assert got["output_bytes"] == m * n * 4
    assert got["bytes_accessed"] is None and got["peak_bytes"] is None  # no allocator on the CPU


@pytest.mark.parametrize("n,d", [(300, 64), (2048, 256)])
def test_k1_node_counts_the_wrappers_operations(n, d):
    """K1's plain version runs outside the FLOP counter, and the wrapper
    reports N·D·(D+1): the count a card's profile of the same node reads
    (the card test holds the two equal)."""
    a = torch.from_numpy(np.random.default_rng(n).normal(size=(n, d)).astype(np.float32))
    prof = cost.analyze(lambda node, b: node(b), transformer(gram.ata_int8, name="gram"), a)
    assert prof["kernel_ops"] == prof["flops"] == float(n) * d * (d + 1)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        gram.int8_gram_plain(gram._quantize_cols(a)[0])
    assert fc.get_total_flops() > 0  # what the counter would have read


def test_record_pipeline_profile_persists_and_instruments(tmp_path):
    pipe = Pipeline.of(transformer(lambda b: b @ torch.ones((8, 4)), name="mm"),
                       transformer(lambda b: b.relu(), name="relu"))
    key = "node_calls{node=00:mm}"
    before = metrics.get_registry().snapshot().get(key, 0)
    profiles = cost.record_pipeline_profile(pipe, torch.ones((16, 8)), save_dir=str(tmp_path))
    assert list(profiles) == ["00:mm", "01:relu"]
    assert profiles["00:mm"]["flops"] == 2 * 16 * 8 * 4
    assert profiles["00:mm"]["input_shapes"] == ["torch.float32[16, 8]"]
    assert cost.load_profiles(str(tmp_path))["profiles"] == profiles
    assert metrics.get_registry().snapshot().get(key, 0) == before + 1
    assert cost.load_profiles(str(tmp_path / "none"))["profiles"] == {}


# --------------------------------------------------------- tracer, devices


def test_step_tracer_writes_one_trace_per_window(tmp_path, monkeypatch):
    """``KEYSTONE_PROFILE_STEPS=1:2`` over a 4-step train: one window
    over steps 1-2, one Chrome trace, recorded with its step range; the
    CPU collects no device activity, so no device count is claimed."""
    from keystone_tpu_torch.models.lm import TransformerLM, synthetic_corpus, train

    monkeypatch.setenv("KEYSTONE_PROFILE_STEPS", "1:2")
    monkeypatch.setenv("KEYSTONE_TRACE_DIR", str(tmp_path))
    seen = []
    real = tracing.StepTracer.close

    def keep(self):
        real(self)
        seen.append(self)

    monkeypatch.setattr(tracing.StepTracer, "close", keep)
    lm = TransformerLM.create(vocab=32, max_seq=16, dim=16, depth=1, num_heads=2, device="cpu")
    train(lm, synthetic_corpus(300, 32), steps=4, batch=2, seq=8)
    (tracer,) = seen
    (window,) = tracer.windows
    assert window["status"] == "ok" and (window["step"], window["steps"]) == (1, 2)
    assert window["device_events"] is None
    assert os.listdir(tmp_path) == ["step_1"]
    with open(os.path.join(tmp_path, "step_1", profiling.TRACE_FILE)) as f:
        assert json.load(f)["traceEvents"]


def _audited_window(tmp_path, monkeypatch, audit):
    """One window closed as if its trace's audit read ``audit``: the
    window's record and the statuses its run log holds."""
    monkeypatch.setattr(tracing, "_audit", lambda prof, path: audit)
    t = tracing.StepTracer([(0, 1)], log_dir=str(tmp_path))
    with events.run(str(tmp_path / "obs")) as log:
        t.step(0)
        t.step(1)
        t.close()
    (window,) = t.windows
    recs = events.read_events(log.run_dir)
    return window, [r["status"] for r in recs if r["event"] == "trace_window"]


def test_step_tracer_records_an_empty_window_as_empty(tmp_path, monkeypatch):
    window, statuses = _audited_window(tmp_path, monkeypatch, {
        "device_events": 0, "lost": 0, "primer_lost": 0, "all_device_events": 0})
    assert window["status"] == "empty" and window["device_events"] is None
    assert window["lost_device_events"] is None
    assert statuses == ["started", "empty"]


def test_step_tracer_records_a_lossy_window_as_incomplete(tmp_path, monkeypatch):
    """A trace lacking the device records of two launches past the primer
    is an incomplete window that says so, not one of fewer launches."""
    window, statuses = _audited_window(tmp_path, monkeypatch, {
        "device_events": 40, "lost": 2, "primer_lost": 9, "all_device_events": 1057})
    assert window["status"] == "incomplete"
    assert (window["device_events"], window["lost_device_events"],
            window["primer_lost_events"]) == (40, 2, 9)
    assert statuses == ["started", "incomplete"]


def _api(name, corr, ts, tid=1):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def _dev(corr, cat="kernel"):
    return {"cat": cat, "name": f"k{corr}", "ts": 1000 + corr, "dur": 1, "tid": 7,
            "args": {"correlation": corr}}


_PRIMER = {"cat": "user_annotation", "name": profiling.PRIMER_REGION, "ts": 0, "dur": 50,
           "tid": 1}
_AUDIT_CASES = {
    "whole": ([_PRIMER, _api("cudaLaunchKernel", 1, 10), _dev(1),
               _api("cudaLaunchKernel", 2, 100), _dev(2),
               _api("cudaMemcpyAsync", 3, 110), _dev(3, "gpu_memcpy"),
               _api("cudaMemsetAsync", 4, 120), _dev(4, "gpu_memset")],
              {"device_events": 3, "lost": 0, "primer_lost": 0, "all_device_events": 4}),
    "primer_took_the_loss": ([_PRIMER, _api("cudaLaunchKernel", 1, 10),
                              _api("cudaLaunchKernel", 2, 20),
                              _api("cuLaunchKernelEx", 3, 100), _dev(3)],
                             {"device_events": 1, "lost": 0, "primer_lost": 2,
                              "all_device_events": 1}),
    "lost_past_the_primer": ([_PRIMER, _api("cudaLaunchKernel", 1, 10), _dev(1),
                              _api("cudaLaunchKernelExC", 2, 100),
                              _api("cudaLaunchKernel", 3, 110), _dev(3)],
                             {"device_events": 1, "lost": 1, "primer_lost": 0,
                              "all_device_events": 2}),
    # captured launches run at the replay, host callbacks on the host
    "capture_and_host_calls": ([_api("cudaStreamBeginCapture", 9, 200),
                                _api("cudaLaunchKernel", 10, 210),
                                _api("cudaStreamEndCapture", 11, 220),
                                _api("cudaLaunchHostFunc", 12, 230),
                                _api("cudaGraphLaunch", 13, 240), _dev(13), _dev(13),
                                _api("cudaLaunchKernel", 14, 250, tid=2)],
                               {"device_events": 2, "lost": 1, "primer_lost": 0,
                                "all_device_events": 2}),
}


@pytest.mark.parametrize("case", sorted(_AUDIT_CASES))
def test_audit_trace_finds_launches_without_device_records(tmp_path, case):
    trace, want = _AUDIT_CASES[case]
    path = tmp_path / profiling.TRACE_FILE
    path.write_text(json.dumps({"traceEvents": trace}))
    assert profiling.audit_trace(str(path)) == want


def test_cpu_sessions_are_not_primed(tmp_path):
    """Without CUDA activity a session runs no primer and is not audited."""
    path = str(tmp_path / "w" / profiling.TRACE_FILE)
    prof = profiling.start_profiler(path)
    torch.ones(4).add_(1)
    profiling.stop_profiler(prof, path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert profiling.PRIMER_REGION not in names and "aten::add_" in names
    assert tracing._audit(prof, path) is None


def test_step_tracer_windows_parse_as_the_jax_packages():
    from keystone_tpu.observe import tracing as j_tracing

    for spec in ("120:10", "5:1, 2:3", ""):
        assert tracing.parse_windows(spec) == j_tracing.parse_windows(spec)
    for bad in ("5", "a:b", "3:0"):
        with pytest.raises(ValueError):
            tracing.parse_windows(bad)


def test_device_monitor_degrades_without_a_card():
    mon = devices.DeviceMemoryMonitor()
    assert devices.sample_device_memory() == [] == j_devices.sample_device_memory()
    assert mon.sample() == [] and mon.maybe_sample() is None and mon.peak_bytes() is None


def test_device_monitor_tracks_a_cards_watermark_as_the_jax_package(monkeypatch):
    """Fed the same allocator readings, the two monitors keep the same
    peak watermark and export the same gauges."""
    readings = [(100, 150), (120, 400), (90, 400), (500, 520)]
    gib = 80 * 2**30
    it = iter(readings)
    monkeypatch.setattr(devices, "_device_count", lambda: 1)
    monkeypatch.setattr(devices, "_device_stats", lambda i: dict(
        zip(("bytes_in_use", "peak_bytes_in_use"), next(it)), bytes_limit=gib))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: "NVIDIA H100 80GB HBM3")

    class FakeDev:
        platform, id, device_kind = "cuda", 0, "NVIDIA H100 80GB HBM3"

    jit = iter(readings)
    monkeypatch.setattr(j_devices, "_device_stats", lambda d: dict(
        zip(("bytes_in_use", "peak_bytes_in_use"), next(jit)), bytes_limit=gib))
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDev()])
    mon, jmon = devices.DeviceMemoryMonitor(), j_devices.DeviceMemoryMonitor()
    for _ in readings:
        got, want = mon.sample(), jmon.sample()
        assert got == want
    assert mon.peak_bytes() == jmon.peak_bytes() == 520
    assert mon.limits == {"cuda:0": gib}
    snap = metrics.get_registry().snapshot()
    assert any("hbm_peak_bytes" in k for k in snap)


# ------------------------------------------------- instrument, profiling


def test_instrument_records_calls_and_skips_captures(monkeypatch):
    pipe = Pipeline.of(transformer(lambda b: b + 1, name="inc"))
    inst = instrument.instrument(pipe, sync=True)
    assert instrument.instrument(inst, sync=True).nodes[0] is inst.nodes[0]
    assert instrument.instrument(inst, sync=False).nodes[0].sync is False
    reg = metrics.get_registry()
    calls, caps = "node_calls{node=00:inc}", "node_captures{node=00:inc}"
    n_calls = reg.snapshot().get(calls, 0)
    assert torch.equal(inst(torch.zeros(3)), torch.ones(3))
    assert reg.snapshot().get(calls, 0) == n_calls + 1
    monkeypatch.setattr(instrument, "_capturing", lambda: True)
    n_caps = reg.snapshot().get(caps, 0)
    assert torch.equal(inst(torch.zeros(3)), torch.ones(3))
    assert reg.snapshot().get(caps, 0) == n_caps + 1
    assert reg.snapshot().get(calls, 0) == n_calls + 1


def test_trace_writes_a_chrome_trace_and_honors_the_kill_switch(tmp_path, monkeypatch):
    monkeypatch.delenv("KEYSTONE_TRACE_DIR", raising=False)
    with profiling.trace(str(tmp_path / "t")) as path:
        with profiling.annotate("region"):
            torch.ones(4).sum()
    assert path == str(tmp_path / "t" / profiling.TRACE_FILE)
    with open(path) as f:
        assert any(e.get("name") == "region" for e in json.load(f)["traceEvents"])
    monkeypatch.setenv("KEYSTONE_TRACE_DIR", "off")
    with profiling.trace(str(tmp_path / "u")) as path:
        pass
    assert path is None and not (tmp_path / "u").exists()


def test_launcher_dispatches_pipelines_and_commands(run_dir, tmp_path):
    run = _launch("--help")
    assert run.returncode != 0 and "mnist-random-fft" in run.stderr and "observe" in run.stderr
    run = _launch("observe", run_dir[0])
    assert run.returncode == 0, run.stderr[-2000:]
    assert "00:FeaturizerBank" in run.stdout
    run = _launch("observe", "top", run_dir[1], "--once")
    assert run.returncode == 0 and "loss" in run.stdout.lower(), run.stderr[-2000:]
    run = _launch("--profile", str(tmp_path / "p"), "stupid-backoff", "--synthetic", "200")
    assert run.returncode == 0, run.stderr[-2000:]
    assert os.path.isfile(tmp_path / "p" / profiling.TRACE_FILE)
    run = _launch("nope")
    assert run.returncode != 0 and "unknown pipeline" in run.stderr
