"""Requests at a fixed rate into the port's continuous-batching decode pool.

The system under test is ``serve/decode_loop.DecodeLoop`` over the
transformer LM of the configuration, served as it states: weight-only
int8 (``quantize_for_decode``) with K4 for the products of at most 64
rows, bf16 activations and KV cache, greedy picks, K2 in the prefills.
The loop captures its pooled step and one prefill per bucket of the mix
as CUDA graphs in set-up; the benchmark drives ``step()`` itself.

The load is open: request ``i`` is due ``i / rate_per_s`` seconds after
the schedule starts, whatever the system does, and is sent when due. The
mix's lengths come from ``harness/traffic`` (the same set for every seed,
in the seed's order). The pool admits queued requests first come, first
served into free slots, one prefill each, at the start of a step; a
request's first token is out when the step that admits it returns.
``ramp_s`` seconds of the schedule run before the window.

- ``ttft_p95_ms``: the 95th percentile, over every request due in the
  window, of the time from when it was due to its first token; after the
  window the schedule runs on until each has its first token, a minute at
  most, and one that never gets it counts as missing.
- ``itl_p95_ms``: the 95th percentile, over every gap of every request
  that closes inside the window, of the time between two steps that hand
  the request tokens: a step's return to the next one's. The admitting
  step hands a request two tokens at once (its prefill's and the pooled
  step's), and they open its first gap together.

``correct``: once the window has closed, a sample of the finished
requests drawn from the seed, the longest among them, is run through the
float32 reference over prompt and served tokens; the widest gap by which
a served token's logit lies below the reference's best at its position
(``served_logit_gap``) is held to its limit.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.harness import peaks
from benchmark.harness import traffic as _traffic
from benchmark.harness import weights as _weights
from benchmark.harness.stats import percentile
from benchmark.harness.trace import annotate, traced_window
from benchmark.reference import transformer_lm as reference
from benchmark.work import lm as work

DRAIN_S = 60.0


class _Request:
    __slots__ = ("prompt", "out", "fut", "t_due", "t_admit", "t_first", "t_last", "pos")

    def __init__(self, prompt, out, fut, t_due):
        self.prompt, self.out, self.fut, self.t_due = prompt, out, fut, t_due
        self.t_admit = self.t_first = self.t_last = None
        self.pos = len(prompt)  # positions in the cache once admitted


def build(run):
    """(the served model, the decode loop) from the seed's weights."""
    from keystone_tpu_torch.core.runtime import resolve_device
    from keystone_tpu_torch.models.lm import quantize_for_decode
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    cfg, p = run.config, run.params
    resolve_device(run.device)  # as the entries take it: float32 stays float32
    leaves = _weights.lm_leaves(run.seed, cfg, run.device)
    model_f = _weights.build_model(leaves, cfg, cfg["compute_dtype"])
    model = quantize_for_decode(model_f).replace(
        int8_kernel="kernel", pos_embed=leaves["pos_embed"].clone()
    )
    del model_f, leaves
    loop = DecodeLoop(
        model, slots=int(p["slots"]), s_max=int(p["s_max"]), kv_dtype=None,
        temperature=0.0, max_new=int(p["output"]["max"]),
        prefill_buckets=tuple(p["prefill_buckets"]), seed=0,
    )
    return model, loop


def bucket(loop, n: int) -> int:
    """The prefill width the loop pads a prompt of ``n`` tokens to."""
    return max(next((w for w in loop.prefill_buckets if w >= n), loop.prefill_buckets[-1]), n)


class _Server:
    """The benchmark's side of the pool: the schedule, the requests in
    flight, and the window's counts, kept raw and turned into work after
    the window."""

    def __init__(self, run, loop):
        self.loop, self.slots = loop, loop.slots
        self.gap = 1.0 / float(run.params["rate_per_s"])
        self.gen = _traffic.requests(run.seed, run.params, run.config["vocab_size"])
        self.next_due = time.perf_counter()
        self.active, self.waiting, self.done, self.failed = [], [], [], []
        self.counting = False
        self.tokens = self.steps = self.attended = 0
        self.step_s = 0.0
        self.prompts: list = []
        self.gaps: list = []
        self.traced_steps = 0
        self.traced_prefills: list = []  # (prompt tokens, bucket width)

    def arrive(self, now: float) -> None:
        """Send every request due by ``now``, stamped with when it was due."""
        while self.next_due <= now:
            prompt, out = next(self.gen)
            r = _Request(prompt, out, self.loop.submit(prompt, max_new=out), self.next_due)
            (self.failed if _failed(r.fut) else self.waiting).append(r)
            self.next_due += self.gap

    def step(self, traced: bool = False) -> None:
        """One ``loop.step()``: the first requests waiting, as many as
        slots are free, are admitted by it, and every request in a slot
        advances one token."""
        admitted = self.waiting[: self.slots - len(self.active)]
        del self.waiting[: len(admitted)]
        self.active.extend(admitted)
        t0 = time.perf_counter()
        for r in admitted:
            r.t_admit = t0
        with annotate("bench.step") if traced else contextlib.nullcontext():
            advanced = self.loop.step()
        t = time.perf_counter()
        for r in admitted:
            r.t_first = t
        if self.counting and not traced:
            self.gaps.extend(t - r.t_last for r in self.active if r.t_last is not None)
        for r in self.active:
            r.t_last = t
        if self.counting:
            self.tokens += len(admitted) + advanced
            self.steps += 1 if advanced else 0
            self.step_s += t - t0
            self.prompts.extend(len(r.prompt) for r in admitted)
            self.attended += sum(r.pos for r in self.active) + advanced
            if traced:
                self.traced_steps += 1 if advanced else 0
                self.traced_prefills.extend((len(r.prompt), bucket(self.loop, len(r.prompt)))
                                            for r in admitted)
        still = []
        for r in self.active:
            r.pos += 1
            if not r.fut.done():
                still.append(r)
            else:
                (self.failed if _failed(r.fut) else self.done).append(r)
        self.active[:] = still

    def serve_until(self, t_end: float, traced: bool = False, until=None) -> None:
        """Follow the schedule until ``t_end`` (or until ``until()`` holds),
        stepping while any request waits or decodes, idle otherwise."""
        while True:
            now = time.perf_counter()
            if now >= t_end or (until is not None and until()):
                return
            self.arrive(now)
            if self.active or self.waiting:
                self.step(traced)
            else:
                time.sleep(max(0.0, min(self.next_due, t_end) - now))

    def pause(self, seconds: float) -> None:
        """Hold the schedule still for ``seconds`` (the profiler's own)."""
        self.next_due += seconds


def run(run) -> None:
    from keystone_tpu_torch.observe import metrics as _metrics

    cfg, p = run.config, run.params
    cuda = run.device == "cuda"
    model, loop = build(run)
    if cuda:
        loop.warm()
    srv = _Server(run, loop)
    srv.serve_until(time.perf_counter() + float(p["ramp_s"]))
    reg = _metrics.get_registry()
    occ0, steps0 = loop.occupancy_steps, reg.counter("serve_decode_steps").value

    t_start = run.start_window()
    srv.counting = True
    holder: dict = {}
    trace_s = float(p["trace_s"]) if run.trace and cuda else 0.0
    if trace_s:
        with traced_window(run.trace_path, holder):
            srv.pause(holder["opened_s"])
            srv.serve_until(time.perf_counter() + trace_s, traced=True)
        srv.pause(holder["overhead_s"] - holder["opened_s"])
    overhead = holder.get("overhead_s", 0.0)  # the profiler's own, left out
    t_untraced = t_start + trace_s + overhead
    srv.serve_until(t_start + overhead + run.seconds)
    t_close = time.perf_counter()
    srv.counting = False
    span = t_close - t_start - overhead
    backlog = len(srv.waiting)

    due = [r for r in srv.done + srv.failed + srv.active + srv.waiting
           if t_start <= r.t_due < t_close]
    srv.serve_until(t_close + DRAIN_S, until=lambda: all(
        r.t_first is not None or r in srv.failed for r in due))
    ttft = [r.t_first - r.t_due if r.t_first is not None else float("inf") for r in due]
    run.attempted = len(due)
    run.failed = sum(1 for r in due if r.t_first is None)
    run.metrics["ttft_p95_ms"] = 1000.0 * percentile(ttft, 95)
    run.metrics["itl_p95_ms"] = 1000.0 * percentile(srv.gaps, 95)
    run.read_memory_peak()

    rec = run.record
    rec["trace"] = holder.get("trace")
    rec["counters"].update(
        occupancy_steps=loop.occupancy_steps - occ0,
        steps=reg.counter("serve_decode_steps").value - steps0, slots=loop.slots,
    )
    waits = [r.t_admit - r.t_due for r in due if r.t_admit is not None and r.t_due >= t_untraced]
    # each generated token's work is affine in the positions it attends
    per_token = work.decode_flops(cfg, 0)
    per_position = work.decode_flops(cfg, 1) - per_token
    flops = (sum(work.prefill_flops(cfg, n) for n in srv.prompts)
             + (srv.tokens - len(srv.prompts)) * per_token + per_position * srv.attended)
    rec["work"].update(window_s=span, step_s=srv.step_s, model_flops=flops, requests=len(due),
                       tokens=srv.tokens, backlog=backlog, admission_waits_s=waits)
    if trace_s:
        rec["work"].update(_kernel_bounds(cfg, loop.slots, srv.traced_steps, srv.traced_prefills))
        if rec["trace"] is not None:
            from benchmark.harness.readers import K4

            run.log(f"K4 launches in the trace {rec['trace'].kernel_count(K4)}: "
                    f"{srv.traced_steps} pooled steps and {len(srv.traced_prefills)} prefills "
                    f"traced, {rec['work']['k4_launches_per_call']} products a step")
    run.log(f"window {span:.3f} s: {len(due)} requests due, {srv.tokens} tokens "
            f"({srv.tokens / span:.1f}/s), {srv.steps} steps, {backlog} waiting at the close, "
            f"ttft p50 {1000 * percentile(ttft, 50):.2f} ms, {len(srv.gaps)} token gaps, "
            f"p50 {1000 * percentile(srv.gaps, 50):.2f} ms")

    sample = _sample(run.seed, srv.done, int(p["check_requests"]))
    served = [(r.prompt, r.fut.result(timeout=0)) for r in sample]
    del loop, model, srv
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    raw = _weights.lm_leaves(run.seed, cfg, run.device)
    w = reference.served_leaves(raw, cfg, int(cfg["serve_weight_bits"]))
    gap = max(float(reference.served_gaps(w, cfg, pr, out).max()) for pr, out in served)
    run.check("served_logit_gap", gap, run.limits["served_logit_gap"])
    rec["check_s"] = time.perf_counter() - t_check
    if run.control:
        low = reference.served_leaves(raw, cfg, int(p["control_weight_bits"]))
        run.check_control("served_logit_gap", max(
            float(reference.served_gaps(w, cfg, pr, out, control=low).max()) for pr, out in served
        ))


def _failed(fut) -> bool:
    if not fut.done():
        return False
    try:
        fut.result(timeout=0)
    except Exception:  # noqa: BLE001 — a request the loop refused or broke
        return True
    return False


def _sample(seed: int, finished: list, k: int) -> list:
    """``k`` finished requests drawn from the seed, the longest among
    them."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: len(r.prompt) + r.out)
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng(_traffic._seed64(seed, 5))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def _kernel_bounds(cfg: dict, slots: int, steps: int, prefills: list) -> dict:
    """The least times of the traced window's K2 and K4 calls. K2: every
    layer of every prefill, one causal call over the prompt's own tokens
    (the bucket's padding is not work the request needs). K4: each
    pooled step and each prefill is a candidate set of block products
    over its rows (the slots, or the bucket's width); which of them K4
    serves, the reader of ``k4.roofline_pct`` learns from K4's launches in
    the trace, so the benchmark copies no dispatch rule of the program."""
    layers = cfg["n_layer"]
    mats = work.block_matmuls(cfg)

    def k4(m):
        return layers * sum(peaks.bound_s(*work.int8_matmul_call(m, i, o), "bfloat16")[0]
                            for i, o in mats)

    k2_s = layers * sum(peaks.bound_s(*work.attention_call(cfg, 1, n), "bfloat16")[0]
                        for n, _ in prefills)
    calls = [(slots, k4(slots))] * steps + [(w, k4(w)) for _, w in prefills]
    return {"k2_prefill_bound_s": k2_s, "k4_calls": sorted(calls),
            "k4_launches_per_call": layers * len(mats)}
