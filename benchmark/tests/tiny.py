"""Tiny cells for the CPU tests: the committed configurations and mixes
with their sizes cut so that a run takes seconds on the CPU."""

from __future__ import annotations

import json
import os
import time

from benchmark.harness import cli, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load(*parts) -> dict:
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


def fit_cell(limits: dict | None = None) -> spec.Cell:
    cfg = _load("configs", "mnist_random_fft.json")
    cfg.update(numFFTs=2, blockSize=512, num_train=3000)
    traffic = _load("traffic", "fits_back_to_back.json")
    traffic["params"].update(warm_fits=1)
    limits = limits or {"fit_pred_err": 0.3, "fit_mean_err": 1e-3}
    return _cell("tiny_fit", cfg, traffic, limits,
                 ["fit_rows_per_s", "setup_s"],
                 ["fit.plan_ms", "fit.stream_ms", "fit.solve_ms", "fit.mfu_pct"])


def lm_config() -> dict:
    cfg = _load("configs", "gpt2_medium.json")
    cfg.update(n_embd=64, n_layer=2, n_head=4, vocab_size=256, n_positions=128)
    return cfg


def decode_cell(limits: dict | None = None) -> spec.Cell:
    traffic = _load("traffic", "chat_open.json")
    traffic["params"].update(
        rate_per_s=60.0, slots=4, s_max=128, prefill_buckets=[8, 16, 32], ramp_s=0.2,
        check_requests=4,
        prompt={"dist": "lognormal", "median": 12, "sigma": 0.6, "min": 4, "max": 32},
        output={"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 8, "max": 64},
    )
    return _cell("tiny_decode", lm_config(), traffic, limits or {"served_logit_gap": 0.05},
                 ["ttft_p95_ms", "itl_p95_ms", "setup_s"],
                 ["serve.queue_wait_ms", "serve.slot_occupancy_pct", "decode.mfu_pct"])


def train_cell(limits: dict) -> spec.Cell:
    """The training cell at a tiny width, computing in float32: at 64
    wide, bf16's rounding alone reads above the limits set at the
    published widths."""
    traffic = _load("traffic", "train_b16s1024.json")
    traffic["params"].update(batch=4, seq=32, ref_rows=2, warm_steps=1)
    cfg = lm_config()
    cfg["compute_dtype"] = "float32"
    return _cell("tiny_train", cfg, traffic, limits,
                 ["train_tokens_per_s", "setup_s"], ["train.mfu_pct"])


def _cell(name, cfg, traffic, limits, e2e, per_layer) -> spec.Cell:
    bench = spec.load_benchmark(ROOT)
    e2e_all = {m["name"]: spec.metric(m) for m in bench["end_to_end"]}
    per_all = {m["name"]: spec.metric(m) for m in bench["per_layer"]}
    return spec.Cell(
        name=name, chips=1, config=cfg, traffic=traffic,
        end_to_end=[e2e_all[m] for m in e2e], per_layer=[per_all[m] for m in per_layer],
        limits=limits,
    )


def execute(cell: spec.Cell, seed: int = 2**31 + 11, seconds: float = 1.0,
            trace: bool = False, control: bool = False) -> tuple[dict, cli.Run]:
    """One run of ``cell`` on the CPU, past the harness's look for a card;
    ``control`` also judges the control, as the readings tool does."""
    cli.prepare_environment(ROOT)
    run = cli.Run(cell, seed, seconds, trace, ROOT, time.perf_counter(), device="cpu")
    run.control = control
    return cli.execute(run), run
