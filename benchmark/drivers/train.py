"""Back-to-back train steps of the transformer LM on one card.

The system under test is ``models/lm/train.make_train_step`` (the
next-token loss, the gradient of every leaf, AdamW in place) over the
port's ``TransformerLM`` at the configuration's widths, computing in
bf16 with float32 master weights and float32 logits, K2's trainable
forward in every layer. The weights come from the seed on the card; each
step's (batch, seq + 1) tokens come from the seed too, every row
different.

Set-up builds the one model and optimizer state, drives them through the
first ``ref_steps`` steps with the window's own step and feed, reads
what the check needs from them, warms ``warm_steps`` more, and hands the
same objects to the window. The card is synchronised after every step.

- ``train_tokens_per_s``: batch · seq · steps over the window, which ends
  at the end of the step that crosses ``--seconds``.

``correct``: the plain float32 reference follows the first steps from the
same weights and tokens; compared are each step's loss, each leaf's first
gradient norm as the optimizer holds it (its first moment over 1 - b1)
and each leaf's change after the first steps, by the worst leaf.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.harness import traffic as _traffic
from benchmark.harness import weights as _weights
from benchmark.harness.trace import annotate, traced_window
from benchmark.reference import lm_train as reference
from benchmark.work import lm as work


def run(run) -> None:
    from keystone_tpu_torch.core.runtime import resolve_device
    from keystone_tpu_torch.models.lm import make_optimizer, make_train_step

    cfg, p = run.config, run.params
    dev = resolve_device(run.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, s, v = int(p["batch"]), int(p["seq"]), cfg["vocab_size"]
    names = [n for n, _, _ in _weights.shapes(cfg)]
    model = _weights.build_model(_weights.lm_leaves(run.seed, cfg, dev), cfg,
                                 cfg["compute_dtype"])
    opt = make_optimizer(float(p["lr"]), weight_decay=float(p["weight_decay"]))
    step = make_train_step(opt)
    state = opt.init(model.leaves())

    def feed(i):
        return _traffic.token_batch(run.seed, i, b, s, v, dev)

    first = int(p["ref_steps"])
    losses = []
    for i in range(first):
        model, state, loss = step(model, state, feed(i))
        losses.append(loss)
        if i == 0:
            grad_norms = [m.norm() / (1 - reference.B1) for m in state.mu]
    sync()
    prog = {
        "losses": [float(x) for x in losses],
        "grad_norms": dict(zip(names, (float(g) for g in grad_norms))),
    }
    w0 = _weights.lm_leaves(run.seed, cfg, dev)
    prog["delta_norms"] = {n: float((w.detach() - w0[n]).norm())
                           for n, w in zip(names, model.leaves())}
    del w0
    i = first
    for _ in range(int(p["warm_steps"])):
        model, state, _ = step(model, state, feed(i))
        i += 1
    sync()

    holder: dict = {}
    trace_steps = int(p["trace_steps"]) if run.trace and cuda else 0
    steps, walls = 0, []
    t_start = run.start_window()
    profiled = traced_window(run.trace_path, holder) if trace_steps else contextlib.nullcontext()
    with profiled:
        for _ in range(trace_steps):
            t0 = time.perf_counter()
            with annotate("bench.train_step"):
                model, state, _ = step(model, state, feed(i))
                sync()
            walls.append(time.perf_counter() - t0)
            i += 1
            steps += 1
    overhead = holder.get("overhead_s", 0.0)  # the profiler's own, left out
    while steps == 0 or time.perf_counter() - t_start - overhead < run.seconds:
        t0 = time.perf_counter()
        model, state, _ = step(model, state, feed(i))
        sync()
        walls.append(time.perf_counter() - t0)
        i += 1
        steps += 1
    span = time.perf_counter() - t_start - overhead
    run.attempted = steps
    run.metrics["train_tokens_per_s"] = b * s * steps / span
    run.read_memory_peak()
    rec = run.record
    rec["trace"] = holder.get("trace")
    rec["work"].update(
        window_s=span, steps=steps, step_walls_s=walls,
        step_flops=work.train_step_flops(cfg, b, s),
        k2_train_bound_s=trace_steps * cfg["n_layer"] * _k2_bound(cfg, b, s),
    )

    del model, state, step
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    w0 = _weights.lm_leaves(run.seed, cfg, dev)
    batches = [feed(j) for j in range(first)]
    ref = reference.first_steps(w0, cfg, batches, float(p["lr"]), float(p["weight_decay"]),
                                int(p["ref_rows"]))
    judge(run, prog, ref)
    rec["check_s"] = time.perf_counter() - t_check
    if run.control:
        low = reference.first_steps(w0, cfg, batches, float(p["lr"]), float(p["weight_decay"]),
                                    int(p["ref_rows"]), compute=p["control_compute"])
        for name, value in readings(low, ref).items():
            run.check_control(name, value)


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, the worst
    leaf's first-gradient norm gap and the worst leaf's change norm gap,
    the last over the leaves whose reference gradient is not nought to
    rounding (over a thousandth of the median leaf's)."""
    loss = max(abs(a - r) / abs(r) for a, r in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    median = sorted(g.values())[len(g) // 2]
    moved = {k for k, x in g.items() if x > 1e-3 * median}
    return {
        "loss_rel_gap": loss,
        "grad_norm_gap": reference.worst_leaf_gap(prog["grad_norms"], g),
        "update_norm_gap": reference.worst_leaf_gap(prog["delta_norms"], ref["delta_norms"], moved),
    }


def judge(run, prog: dict, ref: dict) -> None:
    for name, value in readings(prog, ref).items():
        run.check(name, value, run.limits[name])


def _k2_bound(cfg: dict, b: int, s: int) -> float:
    from benchmark.harness import peaks

    return peaks.bound_s(*work.attention_call(cfg, b, s), "bfloat16")[0]
