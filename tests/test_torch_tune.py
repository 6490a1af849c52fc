"""keystone_tpu_torch's autotuner (``plan/tune.py``) against the JAX
package's: the same injected clock and the same observation sequence, with
the same ``tune.bad_knob`` schedule, give the same knob trajectory, the
same window summaries and the same ``tune`` events, field for field (the
timestamps and run ids aside). Then the port's own wiring: the staging
engine's observation sites, the stage-depth knob's environment write and
its undo by ``reset()``. No real sleeps: every clock is injected."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keystone_tpu.observe import events as j_events  # noqa: E402
from keystone_tpu.plan import tune as j_tune  # noqa: E402
from keystone_tpu.resilience import faults as j_faults  # noqa: E402
from keystone_tpu_torch.core import staging  # noqa: E402
from keystone_tpu_torch.observe import events  # noqa: E402
from keystone_tpu_torch.plan import tune  # noqa: E402
from keystone_tpu_torch.resilience import faults  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Each test starts and ends with no tuner, no faults and the
    stage-depth variable as the process had it."""
    monkeypatch.delenv("KEYSTONE_TUNE", raising=False)
    monkeypatch.delenv("KEYSTONE_STAGE_DEPTH", raising=False)
    for mod in (tune, j_tune, faults, j_faults):
        mod.reset()
    yield
    for mod in (tune, j_tune, faults, j_faults):
        mod.reset()


def _knobs(mod):
    return [
        mod.value_knob("ingest_workers", 2, lo=1, hi=16, scale=2),
        mod.value_knob("stage_depth", 2, lo=1, hi=8, scale=None, step=1),
        mod.value_knob("serve_bucket", 8, lo=1, hi=64, scale=2),
    ]


def _windows(seed: int, n: int):
    """``n`` windows of seeded stall walls and rows: every stall bucket
    dominates some of them, some are idle, some regress."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        walls = {b: float(rng.uniform(0, 0.6)) for b in ("wait_host", "wait_device", "queue")}
        walls[("wait_host", "wait_device", "queue")[rng.integers(3)]] += 0.5
        if rng.random() < 0.25:  # no dominant stall: a hold
            walls = {b: w / 20 for b, w in walls.items()}
        walls["compute"] = float(rng.uniform(0, 0.5))
        rows = 0 if rng.random() < 0.1 else int(rng.integers(5, 60))
        out.append((walls, rows))
    return out


def _drive(mod, ev_mod, run_dir, windows, spec):
    """One tuner of ``mod`` over ``windows``: the knob values after each
    window, its history, and the ``tune`` events it logged."""
    clock = [0.0]
    fault_mod = faults if mod is tune else j_faults
    fault_mod.configure(spec)
    t = mod.Autotuner(
        mod.TuneConfig(window_s=1.0, cooldown_s=2.0, revert_tolerance=0.05,
                       min_share=0.2),
        clock=lambda: clock[0],
    )
    for knob in _knobs(mod):
        t.register(knob)
    t.bind_chunk(4096, fingerprint="fp")
    trajectory = []
    with ev_mod.run(str(run_dir)) as log:
        for walls, rows in windows:
            clock[0] += 1.0
            t.observe(rows=rows, buckets=walls)
            t.tick()
            trajectory.append({k: t.value(k) for k in sorted(t.knobs)})
        path = os.path.join(log.run_dir, "events.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    tune_events = [{k: v for k, v in r.items() if k not in ("ts", "run")}
                   for r in recs if r.get("event") == "tune"]
    return trajectory, list(t.history), tune_events


@pytest.mark.parametrize("seed,spec", [(0, None), (1, "tune.bad_knob:1.0:0:2"),
                                       (2, "tune.bad_knob:0.5:7")])
def test_tuner_matches_jax_window_for_window(tmp_path, seed, spec):
    windows = _windows(seed, 24)
    got = _drive(tune, events, tmp_path / "port", windows, spec)
    want = _drive(j_tune, j_events, tmp_path / "jax", windows, spec)
    assert got[0] == want[0]  # knob trajectory
    assert got[1] == want[1]  # window summaries
    assert got[2] == want[2] and got[2]  # tune events, field for field
    actions = {h.get("action") for h in got[1]}
    assert {"adjust", "commit", "hold"} <= actions
    if spec is not None:
        assert any(h.get("injected") for h in got[1])


def test_knob_steps_and_bounds_match_jax():
    for mod in (tune, j_tune):
        k = mod.value_knob("w", 4, lo=1, hi=8, scale=2)
        assert [k.next_value(+1), k.next_value(-1)] == [8, 2]
        k.set(8)
        assert k.next_value(+1) is None
        add = mod.value_knob("d", 2, lo=1, hi=4, scale=None, step=1)
        assert [add.next_value(+1), add.next_value(-1)] == [3, 1]


def test_tune_config_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("KEYSTONE_TUNE_WINDOW_S", "0.5")
    monkeypatch.setenv("KEYSTONE_TUNE_TOLERANCE", "0.1")
    monkeypatch.delenv("KEYSTONE_TUNE_COOLDOWN_S", raising=False)
    assert vars(tune.TuneConfig.from_env()) == vars(j_tune.TuneConfig.from_env())
    assert tune.TuneConfig.from_env().cooldown_s == 1.0


def test_env_tuner_knobs_and_reset_restores_stage_depth(monkeypatch):
    """``KEYSTONE_TUNE=1`` builds the stage-depth and ingest-worker knobs;
    moving the stage depth writes ``KEYSTONE_STAGE_DEPTH`` (every new
    staged stream reads it) and ``reset()`` puts the variable back: unset
    when it was unset, its old value when it had one."""
    monkeypatch.setenv("KEYSTONE_TUNE", "1")
    monkeypatch.setenv("KEYSTONE_INGEST_WORKERS", "3")
    tune.reset()
    t = tune.active()
    assert set(t.knobs) == {"stage_depth", "ingest_workers"}
    assert t.value("ingest_workers") == 3 and t.value("stage_depth") == 2
    t.knobs["stage_depth"].set(5)
    assert os.environ["KEYSTONE_STAGE_DEPTH"] == "5" and staging.default_stage_depth() == 5
    tune.reset()
    assert "KEYSTONE_STAGE_DEPTH" not in os.environ
    monkeypatch.setenv("KEYSTONE_STAGE_DEPTH", "3")
    t = tune.active()
    t.knobs["stage_depth"].set(6)
    t.knobs["stage_depth"].set(7)
    tune.reset()
    assert os.environ["KEYSTONE_STAGE_DEPTH"] == "3"


class _Recorder:
    def __init__(self):
        self.calls = []

    def observe(self, **kw):
        self.calls.append(kw)


def test_staging_feeds_the_tuner_where_the_jax_package_does():
    """``stage_chunks`` reports each placement as wait_host, ``run_staged``
    each chunk's wait and rows as wait_device, ``fold_staged`` each chunk's
    rows and the final wait (``keystone_tpu/core/staging.py:191, 336,
    410``); with no tuner nothing is observed."""
    rec = _Recorder()
    tune.configure(rec)
    data = torch.arange(40, dtype=torch.float32).reshape(10, 4)

    def chunks():
        for start in range(0, 10, 4):
            part = data[start : start + 4]
            yield torch.nn.functional.pad(part, (0, 0, 0, 4 - part.shape[0])), part.shape[0]

    outs = list(staging.run_staged(chunks(), lambda a: a * 2, CPU))
    assert torch.equal(torch.cat(outs), data * 2)
    host = [c for c in rec.calls if c.get("bucket") == "wait_host"]
    dev = [c for c in rec.calls if c.get("bucket") == "wait_device"]
    assert len(host) == 3 and all(c["wall_s"] >= 0 for c in host)
    assert [c["rows"] for c in dev] == [4, 4, 2]
    rec.calls.clear()
    total = staging.fold_staged(chunks(), lambda s, a, v: s + a[:v].sum(), 0.0, CPU)
    assert float(total) == float(data.sum())
    assert [c["rows"] for c in rec.calls if "rows" in c] == [4, 4, 2]
    assert sum(c.get("bucket") == "wait_device" for c in rec.calls) == 1
    tune.configure(None)
    rec.calls.clear()
    list(staging.run_staged(chunks(), lambda a: a, CPU))
    assert rec.calls == []


def test_train_loop_feeds_the_tuner():
    """The LM train loop reports each step's host batch wall, compute
    wall and tokens (``keystone_tpu/models/lm/train.py:592-608``)."""
    from keystone_tpu_torch.models.lm import TransformerLM, synthetic_corpus, train

    rec = _Recorder()
    tune.configure(rec)
    lm = TransformerLM.create(vocab=32, max_seq=16, dim=16, depth=1, num_heads=2, device="cpu")
    train(lm, synthetic_corpus(200, 32), steps=3, batch=2, seq=8)
    assert len(rec.calls) == 3
    assert all(c["rows"] == 16 and set(c["buckets"]) == {"wait_host", "compute"}
               for c in rec.calls)
