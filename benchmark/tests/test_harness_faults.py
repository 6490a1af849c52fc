"""Each cell's check against the faults its timed path can have, on the
CPU at a tiny size: the run goes on past the look for a card, the timed
path is broken underneath, and ``correct`` must come out false under the
cell's committed limits. (One card: no exchange between cards to leave
out.)"""

from __future__ import annotations

import importlib
import json
import os

import pytest
import torch

from benchmark.tests import tiny


def _limits(cell: str) -> dict:
    with open(os.path.join(tiny.ROOT, "benchmark", "limits", f"{cell}.json")) as f:
        return json.load(f)


def _fit_unchanged(monkeypatch):
    """Every chunk after the first returns the state it was given."""
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator

    orig = BlockLeastSquaresEstimator.fit_stats_update
    seen = {"n": 0}

    def update(self, state, *a, **k):
        seen["n"] += 1
        return orig(self, state, *a, **k) if seen["n"] == 1 else state

    monkeypatch.setattr(BlockLeastSquaresEstimator, "fit_stats_update", update)


def _fit_half_batch(monkeypatch):
    """The stream sees the first half of the rows, its means over them."""
    from keystone_tpu_torch.plan import executor

    orig = executor.fit_stream

    def half(plan, data, labels, *, n_valid=None, init_state=None):
        h = data.shape[0] // 2
        return orig(plan, data[:h], labels[:h], n_valid=h, init_state=init_state)

    monkeypatch.setattr(executor, "fit_stream", half)


def _fit_answer_altered(monkeypatch):
    """The solve's model comes back with its first block negated."""
    import dataclasses

    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator

    orig = BlockLeastSquaresEstimator.fit_stats_finalize

    def finalize(self, state, widths=None):
        m = orig(self, state, widths=widths)
        return dataclasses.replace(m, xs=(-m.xs[0],) + tuple(m.xs[1:]))

    monkeypatch.setattr(BlockLeastSquaresEstimator, "fit_stats_finalize", finalize)


@pytest.mark.parametrize("fault", [_fit_unchanged, _fit_half_batch, _fit_answer_altered])
def test_fit_faults_read_incorrect(monkeypatch, fault):
    cell = tiny.fit_cell(_limits("mnist_fit"))
    out, _ = tiny.execute(cell, seconds=0.3)
    assert out["correct"], out["checks"]
    fault(monkeypatch)
    out, _ = tiny.execute(cell, seconds=0.3)
    assert not out["correct"], out["checks"]


def _decode_unchanged(monkeypatch):
    """The pooled step leaves the cache's positions where they were."""
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    orig = DecodeLoop._pool_step

    def step(self, tok):
        pos = self.cache.pos.clone()
        out = orig(self, tok)
        self.cache.pos.copy_(pos)
        return out

    monkeypatch.setattr(DecodeLoop, "_pool_step", step)


def _decode_half_batch(monkeypatch):
    """The second half of the pool's slots is left out of the step: each
    gets back the token it put in."""
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    orig = DecodeLoop._run_step

    def step(self, tok):
        t = orig(self, tok).copy()
        h = len(t) // 2
        t[h:] = tok[h:]
        return t

    monkeypatch.setattr(DecodeLoop, "_run_step", step)


def _decode_token_altered(monkeypatch):
    """Every slot's token is the next id over where the step produces it."""
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    orig = DecodeLoop._run_step

    def step(self, tok):
        t = orig(self, tok).copy()
        t = (t + 1) % self.model.embed.shape[0]
        return t

    monkeypatch.setattr(DecodeLoop, "_run_step", step)


@pytest.mark.parametrize("cell_name", ["gpt2m_decode", "gpt2m_prefill"])
@pytest.mark.parametrize("fault", [_decode_unchanged, _decode_half_batch, _decode_token_altered])
def test_decode_faults_read_incorrect(monkeypatch, fault, cell_name):
    cell = tiny.decode_cell(_limits(cell_name))
    cell.params["check_requests"] = 1000  # every finished request: each slot's are judged
    out, _ = tiny.execute(cell, seconds=0.5)
    assert out["correct"], out["checks"]
    fault(monkeypatch)
    out, _ = tiny.execute(cell, seconds=0.5)
    assert not out["correct"], out["checks"]


def _train_unchanged(monkeypatch):
    """The optimizer leaves the parameters and its state as they were."""
    train = importlib.import_module("keystone_tpu_torch.models.lm.train")
    monkeypatch.setattr(train.AdamW, "update", lambda self, grads, state, params, sq_norm=None: state)


def _train_half_batch(monkeypatch):
    """The loss and its gradient over the first half of the rows."""
    train = importlib.import_module("keystone_tpu_torch.models.lm.train")

    orig = train.next_token_loss

    def half(model, tokens, logit_chunk=0):
        return orig(model, tokens[: tokens.shape[0] // 2], logit_chunk=logit_chunk)

    monkeypatch.setattr(train, "next_token_loss", half)


def _train_answer_altered(monkeypatch):
    """One leaf's gradient comes out doubled where it is produced."""
    train = importlib.import_module("keystone_tpu_torch.models.lm.train")

    orig = train._grads

    def grads(loss, params):
        g = orig(loss, params)
        g[2] = g[2] * 2
        return g

    monkeypatch.setattr(train, "_grads", grads)


@pytest.mark.parametrize("fault", [_train_unchanged, _train_half_batch, _train_answer_altered])
def test_train_faults_read_incorrect(monkeypatch, fault):
    cell = tiny.train_cell(_limits("gpt2m_train"))
    out, _ = tiny.execute(cell, seconds=0.3)
    assert out["correct"], out["checks"]
    fault(monkeypatch)
    out, _ = tiny.execute(cell, seconds=0.3)
    assert not out["correct"], out["checks"]
    assert torch.isfinite(torch.tensor([c["value"] for c in out["checks"].values()])).all()
