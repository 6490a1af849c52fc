"""keystone_tpu_torch's online learning (``learn/``, the server's
``/admin/*`` surface) against the JAX package's, on the CPU with
numpy-seeded data:

- ``fit_stats_merge`` is commutative and associative, and merges the JAX
  package's way (``keystone_tpu.learn.merge``);
- fit-state persistence round-trips exactly, and a corrupt file or the
  ``refit.state_digest`` drill is refused;
- an incremental refit (bootstrap, fold chunks, publish) gives the JAX
  package's published model, and a from-scratch fit on the union, with
  only the new rows featurized;
- a corrupt or malformed chunk is skipped durably; a config fault halts
  with the chunks still pending;
- a hot swap under a threaded burst fails no request; the shadow gate
  refuses a diverging candidate and promotes an identical one;
  ``divergence`` equals the JAX package's;
- the refit CLI folds a watch directory once; a served checkpoint reloads
  over HTTP and on SIGHUP.

Tolerances: the port against the JAX package 1e-5 of max|out| (float32
sums in another order, the solve amplifying them); a merged or folded
state against one accumulated whole 1e-6 of max(1, max|out|) after the
finalize, the JAX package's own bar (``tests/test_learn.py``)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.core import pipeline as j_pipeline  # noqa: E402
from keystone_tpu.core.serialization import load_fitted as j_load_fitted  # noqa: E402
from keystone_tpu.learn import merge as j_merge  # noqa: E402
from keystone_tpu.learn import refit as j_refit  # noqa: E402
from keystone_tpu.learn import shadow as j_shadow  # noqa: E402
from keystone_tpu.ops import linear as jl  # noqa: E402
from keystone_tpu.ops import weighted_linear as jw  # noqa: E402
from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Identity, Pipeline  # noqa: E402
from keystone_tpu_torch.core.serialization import load_fitted, save_fitted  # noqa: E402
from keystone_tpu_torch.learn import refit  # noqa: E402
from keystone_tpu_torch.learn.merge import (  # noqa: E402
    FitStateError,
    allmerge_fit_state,
    fit_stats_merge,
    load_fit_state,
    save_fit_state,
)
from keystone_tpu_torch.learn.shadow import ShadowRunner, divergence, input_feature_stats  # noqa: E402
from keystone_tpu_torch.learn.swap import ModelSwapper, SwapError  # noqa: E402
from keystone_tpu_torch.observe import health, metrics  # noqa: E402
from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator, LinearMapEstimator  # noqa: E402
from keystone_tpu_torch.ops.weighted_linear import BlockWeightedLeastSquaresEstimator  # noqa: E402
from keystone_tpu_torch.resilience import faults  # noqa: E402
from keystone_tpu_torch.serve.export import ExportedApply  # noqa: E402
from keystone_tpu_torch.serve.server import ServeApp  # noqa: E402

JAX_TOL = 1e-5
UNION_TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counter(name: str) -> float:
    return metrics.get_registry().snapshot().get(name, 0)


def _regression(rng, n, d=10, k=3):
    a = (rng.normal(size=(n, d)) * 1.5 + 0.5).astype(np.float32)
    return a, (a @ rng.normal(size=(d, k)).astype(np.float32) + 0.25).astype(np.float32)


def _classification(rng, n, d=10, k=4):
    a = (rng.normal(size=(n, d)) * 1.5 + 0.5).astype(np.float32)
    y = -np.ones((n, k), np.float32)
    y[np.arange(n), rng.integers(0, k, size=n)] = 1.0
    return a, y


def _accumulate(est, a, b):
    state = est.fit_stats_init(a.shape[-1], b.shape[-1], "cpu")
    return est.fit_stats_update(state, torch.from_numpy(a), torch.from_numpy(b))


def _j_accumulate(est, a, b):
    state = est.fit_stats_init(a.shape[-1], b.shape[-1])
    return est.fit_stats_update(state, jnp.asarray(a), jnp.asarray(b))


def _rel(got, want, floor=0.0) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-30))


# ---------------------------------------------------------------------------
# merge


@pytest.mark.parametrize("kind", ["normal_eq", "weighted"])
def test_merge_commutative_associative_and_as_jax(kind, rng):
    if kind == "normal_eq":
        a, b = _regression(rng, 400)
        est, j_est = LinearMapEstimator(lam=0.7), jl.LinearMapEstimator(lam=0.7)
    else:
        a, b = _classification(rng, 400, d=12)
        kw = dict(block_size=6, num_iter=2, lam=0.5, mixture_weight=0.4)
        est, j_est = BlockWeightedLeastSquaresEstimator(**kw), jw.BlockWeightedLeastSquaresEstimator(**kw)
    cuts = [(i, i + 100) for i in range(0, 400, 100)]
    parts = [_accumulate(est, a[i:j], b[i:j]) for i, j in cuts]
    j_parts = [_j_accumulate(j_est, a[i:j], b[i:j]) for i, j in cuts]
    m = fit_stats_merge
    orders = [
        m(m(m(parts[0], parts[1]), parts[2]), parts[3]),
        m(parts[3], m(parts[2], m(parts[1], parts[0]))),
        m(m(parts[0], parts[2]), m(parts[1], parts[3])),
    ]
    probe = torch.from_numpy(a[:32])
    want = est.fit_stats_finalize(_accumulate(est, a, b))(probe).numpy()
    for merged in orders:
        assert _rel(est.fit_stats_finalize(merged)(probe).numpy(), want, 1.0) <= UNION_TOL
    j_merged = j_merge.fit_stats_merge(j_merge.fit_stats_merge(
        j_merge.fit_stats_merge(j_parts[0], j_parts[1]), j_parts[2]), j_parts[3])
    for f in ("ata", "n") + (("atb", "mean_a", "mean_b") if kind == "normal_eq"
                             else ("at_labels", "class_ata", "class_sum", "sum_a", "n_c")):
        assert _rel(getattr(orders[0], f).numpy(), np.asarray(getattr(j_merged, f))) <= JAX_TOL, f
    # commutative on the raw state
    np.testing.assert_allclose(m(parts[0], parts[1]).ata.numpy(), m(parts[1], parts[0]).ata.numpy(),
                               rtol=1e-6, atol=1e-4)


def test_merge_refusals_identity_and_single_process(rng):
    a, b = _regression(rng, 60, d=8)
    lin = LinearMapEstimator()
    s8 = _accumulate(lin, a, b)
    with pytest.raises(FitStateError, match="different shapes"):
        fit_stats_merge(s8, _accumulate(lin, *_regression(rng, 60, d=6)))
    sw = _accumulate(BlockWeightedLeastSquaresEstimator(), *_classification(rng, 60, d=8, k=3))
    with pytest.raises(FitStateError, match="different types"):
        fit_stats_merge(s8, sw)
    zero = lin.fit_stats_init(8, 3, "cpu")
    merged = fit_stats_merge(zero, s8)
    np.testing.assert_allclose(merged.ata.numpy(), s8.ata.numpy(), rtol=1e-6, atol=1e-5)
    assert float(merged.n) == 60.0
    assert allmerge_fit_state(s8) is s8


# ---------------------------------------------------------------------------
# fit-state persistence


def test_fit_state_round_trip_corruption_and_drill(tmp_path, rng):
    a, b = _regression(rng, 100)
    est = LinearMapEstimator(lam=0.4)
    s = _accumulate(est, a, b)
    path = str(tmp_path / "s.ksts")
    digest = save_fit_state(s, path, est=est, widths=(4, 6), rows=100, version=3)
    assert len(digest) == 64
    fs = load_fit_state(path, device="cpu")
    assert torch.equal(fs.state.ata, s.ata) and torch.equal(fs.state.n, s.n)
    assert type(fs.est) is LinearMapEstimator and fs.est.lam == 0.4
    assert fs.widths == (4, 6) and fs.meta == {"rows": 100, "version": 3}
    assert [p.name for p in tmp_path.iterdir()] == ["s.ksts"]
    faults.configure("refit.state_digest:1:0")
    try:
        with pytest.raises(FitStateError, match="digest mismatch"):
            load_fit_state(path, device="cpu")
    finally:
        faults.reset()
    assert load_fit_state(path, device="cpu").est is not None
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(FitStateError, match="digest mismatch"):
        load_fit_state(path, device="cpu")
    with pytest.raises(FitStateError, match="not a keystone_tpu_torch"):
        load_fit_state(__file__, device="cpu")


# ---------------------------------------------------------------------------
# incremental refit


CASES = {
    "linear_map": (lambda: LinearMapEstimator(lam=0.5), lambda: jl.LinearMapEstimator(lam=0.5),
                   _regression),
    "block": (lambda: BlockLeastSquaresEstimator(block_size=4, num_iter=3, lam=0.5),
              lambda: jl.BlockLeastSquaresEstimator(block_size=4, num_iter=3, lam=0.5),
              _regression),
    "weighted": (lambda: BlockWeightedLeastSquaresEstimator(
        block_size=4, num_iter=3, lam=0.5, mixture_weight=0.4),
        lambda: jw.BlockWeightedLeastSquaresEstimator(
            block_size=4, num_iter=3, lam=0.5, mixture_weight=0.4), _classification),
}


@pytest.mark.parametrize("case", list(CASES))
def test_incremental_refit_matches_jax_and_the_union(tmp_path, rng, case):
    make_est, make_j_est, make_data = CASES[case]
    chunks = [make_data(rng, n) for n in (400, 130, 70)]
    probe = chunks[0][0][:64]
    published = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        watch = root / "chunks"
        watch.mkdir(parents=True)
        state = str(root / "state.ksts")
        a0, b0 = chunks[0]
        if pkg == "jax":
            chain = j_pipeline.ChainedLabelEstimator(prefix=j_pipeline.Identity(), est=make_j_est())
            j_refit.bootstrap_state(chain, a0, b0, state)
            daemon = j_refit.RefitDaemon(state, str(watch), out_dir=str(root))
        else:
            chain = ChainedLabelEstimator(prefix=Identity(), est=make_est())
            refit.bootstrap_state(chain, a0, b0, state, device="cpu")
            daemon = refit.RefitDaemon(state, str(watch), out_dir=str(root), device="cpu")
        for i, (a, b) in enumerate(chunks[1:]):
            np.savez(watch / f"chunk_{i:03d}.npz", data=a, labels=b)
        rows_before = _counter("plan_fused_fit_rows")
        summary = daemon.run_once()
        assert summary["chunks_folded"] == 2 and summary["version"] == 1
        if pkg == "jax":
            published[pkg] = np.asarray(j_load_fitted(summary["model"])(jnp.asarray(probe)))
            continue
        # only the 200 new rows went through the fused featurize+accumulate
        assert _counter("plan_fused_fit_rows") - rows_before == 200
        model, meta = load_fitted(summary["model"], with_meta=True, device="cpu")
        assert meta["version"] == 1 and meta["rows"] == 600
        published[pkg] = model(torch.from_numpy(probe)).numpy()
        ua = torch.from_numpy(np.concatenate([c[0] for c in chunks]))
        ub = torch.from_numpy(np.concatenate([c[1] for c in chunks]))
        full = make_est().fit(ua, ub)(torch.from_numpy(probe)).numpy()
        assert _rel(published[pkg], full, 1.0) <= UNION_TOL
        # idempotent; the offsets persisted
        assert daemon.run_once()["chunks_folded"] == 0
        again = refit.RefitDaemon(state, str(watch), out_dir=str(root), device="cpu")
        assert again.pending() == [] and again.version == 1
        cur = load_fitted(str(root / refit.CURRENT_MODEL), device="cpu")
        assert torch.equal(cur(torch.from_numpy(probe)), model(torch.from_numpy(probe)))
    assert _rel(published["torch"], published["jax"]) <= JAX_TOL


def _bootstrapped(tmp_path, rng, n=150):
    est = LinearMapEstimator(lam=0.2)
    a0, b0 = _regression(rng, n)
    watch = tmp_path / "chunks"
    watch.mkdir()
    state = str(tmp_path / "state.ksts")
    refit.bootstrap_state(ChainedLabelEstimator(prefix=Identity(), est=est), a0, b0, state,
                          device="cpu")
    return est, a0, b0, watch, state


def test_bad_chunks_skip_and_config_faults_halt(tmp_path, rng):
    est, a0, b0, watch, state = _bootstrapped(tmp_path, rng)
    good_a, good_b = _regression(rng, 60)
    wrong_a, _ = _regression(rng, 40, d=17)  # readable, the wrong width
    np.savez(watch / "a_wrong.npz", data=wrong_a, labels=good_b[:40])
    np.savez(watch / "b_good.npz", data=good_a, labels=good_b)
    (watch / "c_torn.npz").write_bytes(b"not an npz at all")
    skipped_before = _counter("refit_chunks_skipped")
    daemon = refit.RefitDaemon(state, str(watch), out_dir=str(tmp_path), device="cpu")
    summary = daemon.run_once()
    assert summary["chunks_folded"] == 1 and summary["chunks_skipped"] == 2
    assert _counter("refit_chunks_skipped") - skipped_before == 2
    inc, meta = load_fitted(summary["model"], with_meta=True, device="cpu")
    assert meta["rows"] == 210
    full = est.fit(torch.from_numpy(np.concatenate([a0, good_a])),
                   torch.from_numpy(np.concatenate([b0, good_b])))
    probe = torch.from_numpy(a0[:16])
    assert _rel(inc(probe).numpy(), full(probe).numpy(), 1.0) <= UNION_TOL
    # the skips are durable
    assert refit.RefitDaemon(state, str(watch), device="cpu").pending() == []
    # the refit.corrupt_chunk drill skips a healthy chunk; a skip-only
    # cycle publishes no version, but its offset is durable
    np.savez(watch / "d_drilled.npz", data=good_a, labels=good_b)
    faults.configure("refit.corrupt_chunk:1:0")
    try:
        summary = daemon.run_once()
    finally:
        faults.reset()
    assert summary == {"chunks_folded": 0, "chunks_skipped": 1, "rows": 0, "version": 1}
    assert refit.RefitDaemon(state, str(watch), device="cpu").pending() == []

    # a config fault: the state's own sample no longer plans to its width
    fs = load_fit_state(state, device="cpu")
    fs.meta["sample"] = np.zeros((1, 17), np.float32)
    save_fit_state(fs.state, state, est=fs.est, prefix=fs.prefix, widths=fs.widths, **fs.meta)
    np.savez(watch / "e_new.npz", data=good_a, labels=good_b)
    with pytest.raises(FitStateError, match="stale or mismatched"):
        refit.RefitDaemon(state, str(watch), device="cpu").run_once()
    assert refit.RefitDaemon(state, str(watch), device="cpu").pending() == ["e_new.npz"]


# ---------------------------------------------------------------------------
# hot swap and shadow


def _checkpoint(tmp_path, rng, name, version, scale=1.0, d=8, k=3):
    a = rng.normal(size=(120, d)).astype(np.float32) * scale
    b = (a @ rng.normal(size=(d, k)).astype(np.float32)).astype(np.float32)
    pipe = Pipeline.of(LinearMapEstimator(lam=0.1).fit(torch.from_numpy(a), torch.from_numpy(b)))
    path = str(tmp_path / name)
    save_fitted(pipe, path, version=version, sample=a[:1])
    return path, a


def _app(path, a):
    pipe = load_fitted(path, device="cpu")
    app = ServeApp(exported=ExportedApply(pipe, a[:1], buckets=(4,), optimize=False, device="cpu"),
                   deadline_ms=2.0, model_version="v1", device="cpu")
    app.swapper = ModelSwapper(app, source_path=path)
    return app


def test_hot_swap_under_threaded_burst_zero_errors(tmp_path, rng):
    p1, a = _checkpoint(tmp_path, rng, "v1.kst", "v1")
    p2, _ = _checkpoint(tmp_path, rng, "v2.kst", "v2")
    p3, _ = _checkpoint(tmp_path, rng, "v3.kst", "v3")
    p_wide, _ = _checkpoint(tmp_path, rng, "wide.kst", "wide", d=12)
    app = _app(p1, a)
    errors, done, stop = [], [0], threading.Event()
    lock = threading.Lock()

    def hammer():
        while not stop.is_set():
            try:
                assert app.predict(a[:2]).shape[0] == 2
                with lock:
                    done[0] += 1
            except Exception as e:  # noqa: BLE001 — collected for the assertion
                errors.append(repr(e))

    threads = [threading.Thread(target=hammer) for _ in range(6)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        r1 = app.swapper.swap_to_path(p2)
        time.sleep(0.1)
        r2 = app.swapper.swap_to_path(p3)
        faults.configure("serve.swap_fail:1:0")
        try:
            failed = _counter("serve_model_swap_failed")
            with pytest.raises(SwapError, match="serve.swap_fail"):
                app.swapper.swap_to_path(p2)
            assert _counter("serve_model_swap_failed") == failed + 1
        finally:
            faults.reset()
        with pytest.raises(SwapError, match="row shape"):
            app.swapper.swap_to_path(p_wide)
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
        app.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and done[0] > 0
    assert (r1["old_version"], r1["new_version"]) == ("v1", "v2")
    assert (r2["old_version"], r2["new_version"]) == ("v2", "v3")
    assert {"load_s", "export_s", "capture_s", "wall_s"} <= set(r2)
    h = app.health()
    assert h["model_version"] == "v3" and h["model_swaps"] == 2 == app.swap_count


def test_shadow_gate_and_divergence(tmp_path, rng):
    p1, a = _checkpoint(tmp_path, rng, "v1.kst", "v1")
    p_bad, _ = _checkpoint(tmp_path, rng, "bad.kst", "bad", scale=50.0)
    app = _app(p1, a)
    try:
        app.start_shadow(p_bad, sample_every=1, min_samples=4, divergence_threshold=0.01)
        for i in range(6):
            app.predict(a[i : i + 2])
        app.shadow.drain()
        verdict = app.health()["shadow"]
        assert verdict["samples"] >= 4 and verdict["mean_divergence"] > 0.01
        res = app.promote_shadow()
        assert res["promoted"] is False and app.shadow is None and app.model_version == "v1"
        # the same weights under a new version pass the gate
        p_same = str(tmp_path / "same.kst")
        save_fitted(load_fitted(p1, device="cpu"), p_same, version="v2-same", sample=a[:1])
        health.reset_monitor()
        app.start_shadow(p_same, sample_every=1, min_samples=4)
        for i in range(6):
            app.predict(a[i : i + 2])
        res = app.promote_shadow()
        assert res["promoted"] is True and app.model_version == "v2-same" and app.swap_count == 1
        assert app.stop_shadow() == {"shadowing": False}
    finally:
        app.shutdown()
    # drift: rows far from the state's means block even a zero-divergence candidate
    est = LinearMapEstimator(lam=0.1)
    s = _accumulate(est, a, a[:, :2])
    path = str(tmp_path / "s.ksts")
    save_fit_state(s, path, est=est, prefix=(Identity(),))
    stats = input_feature_stats(load_fit_state(path, device="cpu"))
    np.testing.assert_allclose(stats[0], a.mean(axis=0), rtol=1e-4, atol=1e-4)
    pipe = Pipeline.of(est.fit_stats_finalize(s))
    exported = ExportedApply(pipe, a[:1], buckets=(4,), optimize=False, device="cpu")
    health.reset_monitor()
    runner = ShadowRunner(exported, "cand", sample_every=1, min_samples=1, feature_stats=stats)
    try:
        shifted = a[:4] + 100.0
        runner.observe(shifted, exported(shifted), rid=0)
        runner.drain()
        v = runner.verdict()
        assert v["drift_alerts"] >= 1 and v["promote"] is False
    finally:
        runner.close()
        health.reset_monitor()
    cases = [
        (np.array([1, 2, 3]), np.array([1, 2, 3])),
        (np.array([1, 2]), np.array([1, 3])),
        (np.array([[0.9, 0.1], [0.2, 0.8]], np.float32), np.array([[0.1, 0.9], [0.2, 0.8]])),
        (np.zeros((2, 2)), np.zeros((3, 2))),
        (rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)),
    ]
    for p, c in cases:
        assert divergence(torch.as_tensor(p), c) == pytest.approx(j_shadow.divergence(p, c))


# ---------------------------------------------------------------------------
# CLI and HTTP smokes


def _env():
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def test_refit_cli_smoke(tmp_path, rng):
    _, a0, b0, watch, state = _bootstrapped(tmp_path, rng, n=200)
    a1, b1 = _regression(rng, 80)
    np.savez(watch / "c0.npz", data=a1, labels=b1)
    cmd = [sys.executable, "-m", "keystone_tpu_torch.learn.refit", state, "--watch", str(watch),
           "--out", str(tmp_path), "--once", "--device", "cpu"]
    out = subprocess.run(cmd, env=_env(), cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["chunks_folded"] == 1 and summary["version"] == 1
    _, meta = load_fitted(summary["model"], with_meta=True, device="cpu")
    assert meta["version"] == 1 and meta["rows"] == 280
    fs = load_fit_state(state, device="cpu")
    assert fs.meta["version"] == 1 and fs.meta["processed"] == ["c0.npz"]
    bad = tmp_path / "bad.ksts"
    bad.write_bytes(open(state, "rb").read()[:-5])
    out = subprocess.run(cmd[:3] + [str(bad)] + cmd[4:], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and "digest mismatch" in out.stderr + out.stdout


def test_serve_admin_reload_and_sighup_over_http(tmp_path, rng, free_tcp_port):
    p1, _ = _checkpoint(tmp_path, rng, "v1.kst", "v1")
    p2, _ = _checkpoint(tmp_path, rng, "v2.kst", "v2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch.serve.server", p1, "--port",
         str(free_tcp_port), "--buckets", "1,4", "--device", "cpu"],
        env={**_env(), "KEYSTONE_SERVE_DEADLINE_MS": "5"}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    base = f"http://127.0.0.1:{free_tcp_port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        deadline, h = time.time() + 120, None
        while time.time() < deadline:
            if proc.poll() is not None:
                pytest.fail("server died: " + proc.stderr.read()[-2000:])
            try:
                h = get("/healthz")
                break
            except OSError:
                time.sleep(0.2)
        assert h is not None and h["model_version"] == "v1" and h["model_swaps"] == 0
        out = post("/admin/reload", {"path": p2})
        assert (out["old_version"], out["new_version"]) == ("v1", "v2")
        assert get("/healthz")["model_swaps"] == 1
        assert len(post("/predict", {"rows": np.zeros((2, 8)).tolist()})["predictions"]) == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/admin/reload", {"path": str(tmp_path / "missing.kst")})
        assert e.value.code == 500 and json.loads(e.value.read())["rolled_back"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/admin/promote", {})
        assert e.value.code == 400  # no shadow running
        # SIGHUP reloads the checkpoint the server was started on
        proc.send_signal(signal.SIGHUP)
        deadline = time.time() + 60
        while get("/healthz")["model_swaps"] < 2 and time.time() < deadline:
            time.sleep(0.1)
        h = get("/healthz")
        assert h["model_swaps"] == 2 and h["model_version"] == "v1"
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert proc.returncode == 0
