"""keystone_tpu_torch's serving stack against the JAX package's, on the
CPU: the micro-batcher's schedule and counters, the exported apply on a
converted MNIST pipeline, the continuous-batching decode pool on a
converted LM, and the HTTP app end to end (``/generate``, ``/predict``,
``/healthz``, ``/metrics``, drain on shutdown).

Tolerances: the micro-batcher, the decode pool's greedy tokens and every
counter are held exactly; the exported apply's classes exactly and its
pre-argmax scores within 1e-4 of max|score| (f32 gemms summed in another
order)."""

import importlib
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from keystone_tpu.models.lm.model import TransformerLM as JTransformerLM  # noqa: E402
from keystone_tpu.serve import server as jserver  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.core.pipeline import Pipeline  # noqa: E402
from keystone_tpu_torch.ops.util import MaxClassifier  # noqa: E402

PACKAGES = ["keystone_tpu", "keystone_tpu_torch"]
BUCKETS = (1, 8, 32)
SCORE_TOL = 1e-4  # of max|score|
LM_CONF = dict(vocab=256, dim=64, depth=2, num_heads=4)
S_MAX, SLOTS = 64, 2


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _other(pkg: str) -> str:
    return PACKAGES[1 - PACKAGES.index(pkg)]


def _snap(pkg: str) -> dict:
    return _mod(pkg, "observe.metrics").get_registry().snapshot()


def _delta(pkg: str, before: dict, names) -> dict:
    after = _snap(pkg)
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


# ---------------------------------------------------------------- models


@pytest.fixture(scope="module")
def mnist():
    """The JAX package's demo MNIST pipeline (2 FFT draws, 256 rows) and
    the port's, converted leaf by leaf: {pkg: (classes pipe, scores
    pipe)} and the sample row."""
    jpipe, sample = jserver._fit_mnist_demo(256, num_ffts=2)
    jbank, jmodel, jmax = jpipe.nodes
    signs = [[np.asarray(c.nodes[0].signs) for c in batch] for batch in jbank.batches]
    bank = convert.featurizer_bank(signs, device="cpu")
    mapper = convert.block_linear_mapper(
        [np.asarray(x) for x in jmodel.xs],
        None if jmodel.b is None else np.asarray(jmodel.b),
        None if jmodel.means is None else [np.asarray(m) for m in jmodel.means],
        block_size=jmodel.block_size,
        device="cpu",
    )
    jscores = type(jpipe).of(jbank, jmodel)
    return {
        "keystone_tpu": (jpipe, jscores),
        "keystone_tpu_torch": (Pipeline.of(bank, mapper, MaxClassifier()), Pipeline.of(bank, mapper)),
    }, sample


@pytest.fixture(scope="module")
def lms():
    jlm = JTransformerLM.create(jax.random.key(0), max_seq=S_MAX, **LM_CONF)
    tlm = convert.transformer_lm(
        {
            "embed": jlm.embed,
            "pos_embed": jlm.pos_embed,
            "blocks": [
                {n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                for b in jlm.blocks
            ],
        },
        num_heads=LM_CONF["num_heads"],
        device="cpu",
    )
    return {"keystone_tpu": jlm, "keystone_tpu_torch": tlm}


def _requests(n: int = 6, seed: int = 11):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 21, size=n)
    news = rng.integers(3, 10, size=n)
    prompts = [rng.integers(0, LM_CONF["vocab"], size=int(k)).astype(np.int32) for k in lens]
    return prompts, [int(k) for k in news]


def _loop(pkg, lms, **kw):
    return _mod(pkg, "serve.decode_loop").DecodeLoop(
        lms[pkg], slots=SLOTS, s_max=S_MAX, max_new=8, **kw
    )


def _exported(pkg, mnist, scores: bool = False):
    pipes, sample = mnist
    kw = {} if pkg == "keystone_tpu" else {"device": "cpu"}
    return _mod(pkg, "serve.export").ExportedApply(
        pipes[pkg][1 if scores else 0], sample, buckets=BUCKETS, **kw
    )


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------- micro-batcher


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class Recorder:
    """Dispatch stub: records every batch shape, returns rows doubled; a
    batch whose first row is filled with 6 raises."""

    def __init__(self):
        self.shapes = []

    def __call__(self, batch):
        self.shapes.append(tuple(batch.shape))
        if batch[0, 0] == 6:
            raise RuntimeError("injected dispatch failure")
        return np.asarray(batch) * 2.0


BATCHER_COUNTERS = (
    "serve_requests", "serve_rows", "serve_batches", "serve_pad_rows",
    "serve_deadline_miss", "serve_dispatch_errors",
)


def _batcher_run(pkg: str) -> dict:
    queue = _mod(pkg, "serve.queue")
    before = _snap(pkg)
    clock, rec = Clock(), Recorder()
    b = queue.MicroBatcher(rec, buckets=(2, 4, 8), deadline_ms=10.0, clock=clock, start=False)
    rows = [np.full((n, 3), i, np.float32) for i, n in enumerate((1, 3, 5, 2, 3, 12, 6, 1))]
    futs, ran = [], []

    def pump(now):
        clock.t = now
        ran.append(b.pump(now=now))

    futs.append(b.submit(rows[0], rid=0))
    clock.t = 0.002
    futs.append(b.submit(rows[1], rid=1))
    pump(0.005)  # nothing due: 4 rows, the oldest 5 ms old
    wait = b.wait_s(now=0.005)
    pump(0.011)  # the deadline: one batch of 4
    clock.t = 0.02
    for i in (2, 3, 4):
        futs.append(b.submit(rows[i], rid=i))
    pump(0.02)  # 10 rows ≥ 8: 5 + 2 ship, 3 wait
    pump(0.031)  # the 3 rows, past their deadline: a miss
    clock.t = 0.04
    futs.append(b.submit(rows[5], rid=5))  # oversized: ships alone
    pump(0.04)
    futs.append(b.submit(rows[6], rid=6))  # the dispatch raises
    pump(0.06)
    clock.t = 0.07
    futs.append(b.submit(rows[7], rid=7))
    b.close(drain=True)  # drains the last request
    shed = b.submit(rows[7])
    results = []
    for f, r in zip(futs, rows):
        try:
            out = np.asarray(f.result(timeout=0))
            np.testing.assert_array_equal(out, r * 2.0)
            results.append(out.shape)
        except RuntimeError as e:
            results.append(str(e))
    with pytest.raises(queue.RequestShed):
        shed.result(timeout=0)
    snap = _snap(pkg)
    return {
        "shapes": rec.shapes,
        "ran": ran,
        "wait_ms": round(wait * 1e3, 6),
        "results": results,
        "counters": _delta(pkg, before, BATCHER_COUNTERS),
        "queue_depth": snap["serve_queue_depth"],
        "batch_fill": snap["serve_batch_fill"],
    }


@pytest.mark.parametrize("pkg", PACKAGES)
def test_micro_batcher_matches_across_packages(pkg):
    got = _batcher_run(pkg)
    assert got == _batcher_run(_other(pkg))
    assert got["shapes"] == [(4, 3), (8, 3), (4, 3), (12, 3), (8, 3), (2, 3)]
    assert got["ran"] == [0, 1, 1, 1, 1, 1]
    assert got["counters"] == {
        "serve_requests": 8, "serve_rows": 33, "serve_batches": 5,
        # a failed dispatch counts no batch and no pad; the requests of
        # 0 ms and 20 ms shipped at 11 and 31 ms, past the 10 ms deadline
        "serve_pad_rows": 1 + 1 + 1, "serve_deadline_miss": 2,
        "serve_dispatch_errors": 1,
    }
    assert got["results"][6] == "injected dispatch failure"


def test_micro_batcher_threaded_resolves_every_request():
    from keystone_tpu_torch.serve.queue import MicroBatcher

    b = MicroBatcher(lambda x: torch.from_numpy(x) + 1, buckets=(4, 16), deadline_ms=2.0)
    try:
        futs = [b.submit(np.full((1 + i % 5, 2), i, np.float32)) for i in range(40)]
        for i, f in enumerate(futs):
            out = f.result(timeout=30)
            assert out.shape == (1 + i % 5, 2) and bool((out == i + 1).all())
    finally:
        b.close()


def test_env_knobs(monkeypatch):
    from keystone_tpu_torch.serve import queue

    assert queue.DEFAULT_BUCKETS == (1, 8, 32)
    monkeypatch.setenv("KEYSTONE_SERVE_BUCKETS", "16,2,2,4")
    monkeypatch.setenv("KEYSTONE_SERVE_DEADLINE_MS", "7.5")
    assert queue.buckets_from_env() == (2, 4, 16)
    assert queue.deadline_ms_from_env() == 7.5
    monkeypatch.setenv("KEYSTONE_SERVE_BUCKETS", "0,x")
    monkeypatch.setenv("KEYSTONE_SERVE_DEADLINE_MS", "-1")
    assert queue.buckets_from_env() == queue.DEFAULT_BUCKETS
    assert queue.deadline_ms_from_env() == queue.DEFAULT_DEADLINE_MS


# --------------------------------------------------------------- export


@pytest.mark.parametrize("n", [1, 5, BUCKETS[-1] + 5])
def test_exported_apply_matches_jax(mnist, n):
    """n = 1, a mid-bucket size, and past the largest bucket (the
    serve_stream path)."""
    x = np.random.default_rng(n).normal(size=(n, 784)).astype(np.float32)
    want_cls = np.asarray(_exported("keystone_tpu", mnist)(x))
    want = np.asarray(_exported("keystone_tpu", mnist, scores=True)(x))
    before = _snap("keystone_tpu_torch")
    got_cls = _host(_exported("keystone_tpu_torch", mnist)(x))
    got = _host(_exported("keystone_tpu_torch", mnist, scores=True)(x))
    assert got.shape == want.shape == (n, 10)
    np.testing.assert_array_equal(got_cls, want_cls)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= SCORE_TOL, err
    streamed = _delta("keystone_tpu_torch", before, ["serve_stream_batches"])
    assert streamed["serve_stream_batches"] == (2 if n > BUCKETS[-1] else 0)


def test_exported_apply_rejects_and_refuses(mnist):
    from keystone_tpu_torch.serve.export import export_pipeline

    exported = _exported("keystone_tpu_torch", mnist)
    assert exported._graphs == {}  # the CPU runs the apply eagerly
    with pytest.raises(ValueError, match="row shape"):
        exported(np.zeros((2, 5), np.float32))
    # a checkpoint path is loaded (tests/test_torch_learn.py serves one);
    # a path that is not there is refused
    with pytest.raises(FileNotFoundError):
        export_pipeline("/some/checkpoint.kst", np.zeros((1, 784), np.float32), device="cpu")
    with pytest.raises(ValueError, match="buckets"):
        export_pipeline(mnist[0]["keystone_tpu_torch"][0], mnist[1], buckets=(0,), device="cpu")


# ----------------------------------------------------------- decode pool

DECODE_COUNTERS = (
    "serve_decode_requests", "serve_decode_prefills", "serve_decode_steps",
    "serve_decode_tokens", "serve_decode_finished",
)


def _decode_run(pkg, lms):
    prompts, news = _requests()
    loop = _loop(pkg, lms)
    before = _snap(pkg)
    futs = [loop.submit(p, max_new=k, rid=i) for i, (p, k) in enumerate(zip(prompts, news))]
    while not all(f.done() for f in futs):
        if loop.step() == 0 and not loop.pending():
            break
    outs = [np.asarray(f.result(timeout=0)).tolist() for f in futs]
    return outs, _delta(pkg, before, DECODE_COUNTERS), loop


@pytest.mark.parametrize("pkg", PACKAGES)
def test_decode_loop_matches_across_packages(pkg, lms):
    """Slots 2, 6 requests: slots retire and refill in flight; the same
    greedy tokens and the same serve_decode_* counters."""
    outs, counters, loop = _decode_run(pkg, lms)
    want_outs, want_counters, _ = _decode_run(_other(pkg), lms)
    assert outs == want_outs
    assert counters == want_counters
    _, news = _requests()
    assert [len(o) for o in outs] == news
    assert counters["serve_decode_prefills"] == 6 and counters["serve_decode_finished"] == 6
    assert counters["serve_decode_tokens"] == sum(news) - 6  # the first tokens come from prefill


def test_decode_loop_pool_state_stays_in_place(lms):
    """The pool's buffers are written in place and ``pos`` stays a
    (slots,) tensor, even at one slot: the step graph on the card reads
    the same buffers on every replay, and decode_step's scalar-position
    branch (a host read) is never taken."""
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    for slots in (1, 2):
        loop = DecodeLoop(lms["keystone_tpu_torch"], slots=slots, s_max=S_MAX, max_new=4)
        ptrs = (loop.cache.k.data_ptr(), loop.cache.v.data_ptr(), loop.cache.pos.data_ptr())
        pos0 = loop.cache.pos.clone()
        loop.warm()
        assert torch.equal(loop.cache.pos, pos0)
        loop.run([[1, 2, 3], [4, 5]], max_new=4)
        assert loop.cache.pos.shape == (slots,)
        assert (loop.cache.k.data_ptr(), loop.cache.v.data_ptr(), loop.cache.pos.data_ptr()) == ptrs
        assert not loop.graphed  # the CPU runs eagerly


def test_decode_loop_slot_spans(lms, tmp_path):
    from keystone_tpu_torch.observe import events, spans

    loop = _loop("keystone_tpu_torch", lms)
    with events.run(base_dir=str(tmp_path), run_id="decode"):
        log = spans.active_span_log()
        with spans.span("serve.request", rid=0):
            fut = loop.submit([5, 6, 7], max_new=3, rid=0)
        while not fut.done():
            loop.step()
        recs = list(log.records)
    by_name = {r["name"]: r for r in recs}
    assert {"serve.request", "decode.prefill", "serve.generate"} <= set(by_name)
    assert by_name["decode.prefill"]["parent"] == by_name["serve.generate"]["span"]
    assert by_name["serve.generate"]["parent"] == by_name["serve.request"]["span"]
    assert by_name["serve.generate"]["tokens"] == 3


def test_export_lm_on_cpu(lms):
    from keystone_tpu_torch.serve.export import export_lm

    before = _snap("keystone_tpu_torch")
    loop = export_lm(lms["keystone_tpu_torch"], slots=2, s_max=S_MAX, quantize=True, max_new=4)
    # the JAX package's CPU route for int8 weights; K4 is the card's
    assert loop.model.int8_kernel == "mm"
    outs = loop.run([[1, 2, 3], [9]], max_new=4)
    assert [len(o) for o in outs] == [4, 4]
    # nothing is captured on the CPU
    assert _delta("keystone_tpu_torch", before, ['serve_aot_compiled{kind=prefill}'])[
        "serve_aot_compiled{kind=prefill}"] == 0


# ----------------------------------------------------------------- HTTP

HEALTH_KEYS = {
    "status", "draining", "requests", "batches", "shed", "queue_depth",
    "batch_fill", "slots_active", "model_version", "queue_p50_ms",
    "queue_p95_ms", "http_p50_ms", "http_p95_ms",
}
SERIES = (
    "serve_requests_total", "serve_rows_total", "serve_batches_total",
    "serve_pad_rows_total", "serve_queue_depth", "serve_batch_fill",
    "serve_request_seconds_count", "serve_http_seconds_count",
    "serve_decode_requests_total", "serve_decode_prefills_total",
    "serve_decode_steps_total", "serve_decode_tokens_total",
    "serve_slots_active", "serve_slot_fill", "serve_decode_finished_total",
)


@pytest.fixture(scope="module")
def expected(mnist, lms):
    """What the JAX package answers, called directly."""
    prompts, news = _requests()
    loop = _loop("keystone_tpu", lms)
    futs = [loop.submit(p, max_new=k) for p, k in zip(prompts, news)]
    while not all(f.done() for f in futs):
        loop.step()
    rows = np.random.default_rng(3).normal(size=(40, 784)).astype(np.float32)
    return {
        "tokens": [np.asarray(f.result(0)).tolist() for f in futs],
        "rows": rows,
        "classes": np.asarray(_exported("keystone_tpu", mnist)(rows)).tolist(),
    }


def _serve(pkg, mnist, lms):
    server = _mod(pkg, "serve.server")
    kw = {} if pkg == "keystone_tpu" else {"device": "cpu"}
    app = server.ServeApp(
        exported=_exported(pkg, mnist), decode_loop=_loop(pkg, lms),
        deadline_ms=2.0, model_version="demo", **kw,
    )
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server._handler_for(app))
    th = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    return app, httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _concurrently(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    ths = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ths)
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_http_app_answers_as_the_jax_package(pkg, mnist, lms, expected):
    prompts, news = _requests()
    rows = expected["rows"]
    cuts = [(0, 1), (1, 6), (6, 40)]
    app, httpd, th, url = _serve(pkg, mnist, lms)
    try:
        gen = [lambda p=p, k=k: _post(url + "/generate", {"prompt": p.tolist(), "max_new": k})
               for p, k in zip(prompts, news)]
        pred = [lambda a=a, b=b: _post(url + "/predict", {"rows": rows[a:b].tolist()})
                for a, b in cuts]
        answers = _concurrently(gen + pred)
        assert all(code == 200 for code, _ in answers)
        assert [a["tokens"] for _, a in answers[: len(gen)]] == expected["tokens"]
        classes = sum((a["predictions"] for _, a in answers[len(gen):]), [])
        assert classes == expected["classes"]
        health = json.loads(_get(url + "/healthz"))
        assert set(health) - {"model_swaps"} == HEALTH_KEYS and health["model_swaps"] == 0
        assert health["status"] == "ok" and health["model_version"] == "demo"
        text = _get(url + "/metrics")
        names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
                 if line and not line.startswith("#")}
        assert set(SERIES) <= names, set(SERIES) - names
        # /admin/* is the online-learning surface: an app built without a
        # swapper refuses a reload (tests/test_torch_learn.py reloads one)
        code = None
        try:
            _post(url + "/admin/reload", {})
        except urllib.error.HTTPError as e:
            code = e.code
        assert code == 409
        # drain: requests in flight when shutdown() starts all complete
        inflight = []
        workers = [threading.Thread(target=lambda: inflight.append(
            _post(url + "/generate", {"prompt": [4, 5, 6, 7], "max_new": 8}))) for _ in range(4)]
        for w in workers:
            w.start()
        deadline = time.monotonic() + 30
        while not app.loop.pending() and len(inflight) < 4 and time.monotonic() < deadline:
            time.sleep(0.001)
        app.shutdown()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
        assert len(inflight) == 4 and all(c == 200 and len(a["tokens"]) == 8 for c, a in inflight)
        assert json.loads(_get(url + "/healthz"))["draining"] is True
    finally:
        app.shutdown()
        httpd.shutdown()
        th.join(timeout=30)


def test_serve_drop_fault_sheds_exactly_the_keyed_request(mnist):
    from keystone_tpu_torch.resilience import faults
    from keystone_tpu_torch.serve.server import OverloadShed, ServeApp

    app = ServeApp(exported=_exported("keystone_tpu_torch", mnist), deadline_ms=1.0, device="cpu")
    row = np.zeros((1, 784), np.float32)
    faults.configure("serve.drop:@1:0,serve.slow_request:@2:0")
    try:
        before = _snap("keystone_tpu_torch")
        assert app.predict(row).shape == (1,)  # rid 0
        with pytest.raises(OverloadShed):  # rid 1: the keyed drop
            app.predict(row)
        assert app.predict(row).shape == (1,)  # rid 2: slowed, answered
        assert _delta("keystone_tpu_torch", before, ["serve_shed", "serve_slowed"]) == {
            "serve_shed": 1, "serve_slowed": 1}
    finally:
        faults.reset()
        app.shutdown()


def test_build_app_targets_on_cpu():
    from keystone_tpu_torch.serve import server

    app = server.build_app("mnist", {"synthetic": "300", "num_ffts": "1", "buckets": "2,4"},
                           device="cpu")
    try:
        assert app.exported.buckets == (2, 4)
        rows = np.random.default_rng(0).normal(size=(3, 784)).astype(np.float32)
        want = app.exported.pipe(torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(app.predict(rows), want)
    finally:
        app.shutdown()
    app = server.build_app("lm", {"slots": "2", "s_max": "32", "max_new": "3", "quantize": True,
                                  "vocab": "64", "dim": "32", "heads": "2"}, device="cpu")
    try:
        out = app.generate([1, 2, 3])
        assert out.shape == (3,) and ((out >= 0) & (out < 64)).all()
    finally:
        app.shutdown()
    with pytest.raises(SystemExit, match="unknown model"):
        server.build_app("nope", {}, device="cpu")
    # a path is served as a save_fitted checkpoint, and this file is not one
    with pytest.raises(ValueError, match="not a keystone_tpu_torch"):
        server.build_app(__file__, {}, device="cpu")
    with pytest.raises(SystemExit):
        server._parse(["lm", "--bogus"])
    assert server._parse(["lm", "--port", "0", "--quantize"]) == ("lm", {"port": "0", "quantize": True})


def test_serve_app_refuses_a_model_on_another_device(mnist):
    from keystone_tpu_torch.serve.server import ServeApp

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the app would be made on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeApp(exported=_exported("keystone_tpu_torch", mnist))
