"""The port's multi-process layer on four NVIDIA cards, one process a card,
over NCCL.

    python3 chip_multicard.py        # on a machine with four cards

It prints the cards' names and power limits first, builds the kernels,
runs the one-process references on card 0, then launches four processes
through the run supervisor (``supervise --procs 4 -- chip_multicard.py
--worker DIR``), each joining the process group on its own card:

1. MNIST random-FFT's streamed int8 fit at the main path's size (60,000
   rows, D = 16,384, chunks of 8,192), 15,000 rows a rank: K1 once a fit
   chunk on every rank, test error ≤ 1 %, ≥ 99.5 % of the test
   predictions as the one-process int8 fit on card 0, the weights'
   distance printed;
2. three training steps at the bench's flagship width (vocab 32,768, dim
   1,024, 16 heads, seq 2,048, batch 8, 2 rows a card): in f32 at depth 2
   against one process from the same weights (losses within 1e-5
   relative, first-step gradients within 1e-5 of max|g|, weights as
   ``chip_smoke.check_f32_leg`` holds them), and in bf16 at depth 8 (K2 8
   a step on every rank, a falling loss, ms a step on each rank);
3. one NCCL all-reduce of the bf16 model's gradients (f32, in one flat
   buffer): ms and bus GB/s (2·(n−1)/n of the bytes a rank sends);
4. tensor parallelism over a model axis of four cards: ``train`` in bf16
   at depth 8 (ms a step and peak memory a rank, K2 8 a step a rank at
   (8, 4, 2,048, 64)), and f32 at depth 2 against one process on card 0
   under ``chip_smoke.check_par_leg``'s bars (losses 1e-5 relative,
   first-step gradients 1e-5 of max|g|, weights' RMS 5e-5 of max|w|);
5. dp × tp on (2, 2): the same f32 leg against one process, and bf16
   ``train`` at depth 8 (ms a step);
6. GPipe over four stages, bf16 at depth 8, ``n_micro`` 8: ms a step, K2
   16 a step a rank, the predicted bubble (S−1)/(S−1+M) beside the
   measured one (1 − the stages' busy share of the pipe, from CUDA events
   around each stage's forward and backward);
7. ring and Ulysses scoring at seq 8,192 over the four cards (phase 13's
   model and windows): ms a forward, K3 per rank exactly (rank r runs r+1
   hops a layer), one ring hop's peer GB/s (a (2, 16, 2,048, 64) bf16 K
   and V block to the next card), one ``all_to_all``'s ms at that shape,
   and a ring train step after one that warms it (K3 10 a layer over the
   ranks);
8. after each of 4-7, the parameters hash the same on every rank;
9. serving a model sharded over a model axis of the four cards (TP
   (1, 4)) at the decode width: f32 at depth 2, teacher-forced prefill
   and 32 decode steps of ``shard_params(m)`` and of
   ``quantize_for_decode(shard_params(m))`` against one process on card 0
   at ``chip_smoke``'s phase 45 bars (within 1e-5 of max|logit|, the
   gathered codes and scales bit for bit, the row-split ``wo``/``w2``
   scaled by their max over the cards), K2 2 and K4 384 a rank; then
   ``export_lm(shard_params(m), quantize=True, int8_kv=True)`` in bf16
   at depth 8 with phase 45's 8 prompts on every rank (128 tokens, 256
   new): the same tokens on every rank, whether the pool was captured as
   CUDA graphs with its NCCL collectives (printed), K4 48 a step replay
   and K2 8 a prefill replay a rank by kernel name, ms a pooled step and
   tokens/s;
10. the last multi-process paths: (a) the class-weighted fit of a global
   batch at ``weighted_imagenet``'s shape (N 16,384, D 4,096, C 1,000, 4,096
   rows a rank, the masked layout) against one process's fits on card 0:
   in float64 within 1e-10 of max|W| of its float64 fit of the same
   layout, in f32 within 2e-3 of max|W| of that fit, of its f32 fit of the
   same layout and of its grid fit, with the grid fit under TF32 Grams
   beyond 2e-3 (``chip_smoke.check_weighted``); each rank's rows, fit
   seconds and all-reduce bytes (the largest a class chunk's Grams);
   (b) MNIST's streamed int8 fit over a (data 2, model 2) mesh, 30,000
   rows a data row held by both of its model positions: K1 once a fit
   chunk on every rank, the same weights on every rank, test error ≤ 1 %
   and ≥ 99.5 % of the test predictions as the one-process int8 fit; (c)
   pp × tp on a (pipe 2, data 1, model 2) mesh, two stages of four blocks
   with 8 heads a position: three bf16 train steps at the flagship width
   (K2 8 a step a rank, falling finite losses, ms a step) and an f32 leg
   at depth 2 against one process on card 0 at part 4's bars.

Every NCCL communicator is warmed before it is timed: its first use
builds it.

The line before the last is ``{"multicard": {...}}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4}}``.
Without four cards it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs

PROCS = 4
STEPS = cs.DP_TRAIN_STEPS
ALLREDUCE_REPS = 10
TIMEOUT_S = 1500
PP_MICRO = 8
COMM_REPS = 10
WEIGHTED = "weighted_imagenet"
# pp × tp: two stages, each stage's blocks over a model axis of two
PPTP_AXES = {"pipe": 2, "data": 1, "model": 2}
PPTP_KW = dict(n_micro=2, axis="pipe", data_axis="data")


def _event_ms(fn, reps: int = COMM_REPS) -> list:
    """Each of ``reps`` calls of ``fn`` (after three that warm it) timed
    with CUDA events, sorted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def _warm(mesh) -> None:
    """One all-reduce over each of ``mesh``'s process groups: NCCL builds a
    communicator at its first use."""
    from keystone_tpu_torch.parallel.collectives import all_reduce

    for axis in mesh.axis_names:
        group = mesh.axis_group(axis)
        if group is not None:
            all_reduce(torch.ones(1, device=torch.cuda.current_device()), group)
    torch.cuda.synchronize()


def parallel_parts(device, out_dir: str) -> dict:
    """Parts 4-8 on this rank."""
    from keystone_tpu_torch.models.lm import (
        make_optimizer,
        make_pp_train_step,
        make_train_step,
        unshard_params,
    )
    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus
    from keystone_tpu_torch.parallel import create_mesh, multihost
    from keystone_tpu_torch.parallel import pipeline_parallel as pp
    from keystone_tpu_torch.parallel.collectives import all_to_all_cat, shift

    rank = multihost.process_index()
    res: dict = {}
    for tag, (n_data, n_model) in (("tp", (1, PROCS)), ("dptp", (2, PROCS // 2))):
        mesh = create_mesh(data=n_data, model=n_model)
        _warm(mesh)
        res[tag] = cs.dist_f32_leg(device, mesh, out_dir, tag)
        torch.cuda.empty_cache()
        bf16 = cs.tp_bf16_leg(device, mesh)
        res[tag]["bf16"] = {k: bf16[k] for k in ("losses", "launches", "ms_per_step",
                                                 "peak_bytes")}
        res[tag]["bf16"]["replicas_equal"] = cs.replicas_equal(
            unshard_params(bf16.pop("model")).leaves())
        torch.cuda.empty_cache()

    # GPipe: four stages over the cards, bf16 at depth 8
    mesh = create_mesh(data=1, model=PROCS)
    corpus = synthetic_corpus(200_000, cs.TRAIN_CONF["vocab"], seed=0)
    batches = [torch.from_numpy(_step_batch(corpus, 0, i, cs.TRAIN_BATCH, cs.TRAIN_SEQ)).to(device)
               for i in range(STEPS + 1)]
    model = cs._par_model(device, cs.TRAIN_CONF["depth"], "bfloat16")
    optimizer = make_optimizer(cs.TRAIN_LR, steps=STEPS + 1)
    state = optimizer.init(model.leaves())
    step = make_pp_train_step(optimizer, mesh, n_micro=PP_MICRO)
    model, state, _ = step(model, state, batches[0])
    torch.cuda.synchronize()
    cs._zero_counts()
    t0 = time.perf_counter()
    losses = []
    for toks in batches[1:]:
        model, state, loss = step(model, state, toks)
        losses.append(float(loss))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cs._counts()
    pp.STAGE_EVENTS = []
    step(model, state, batches[0])
    torch.cuda.synchronize()
    busy = sum(a.elapsed_time(b) for kind, a, b in pp.STAGE_EVENTS if kind == "stage")
    pipe = sum(a.elapsed_time(b) for kind, a, b in pp.STAGE_EVENTS if kind == "pipe")
    pp.STAGE_EVENTS = None
    res["gpipe"] = {"losses": losses, "launches": counts, "ms_per_step": wall * 1e3 / STEPS,
                    "stage_busy_ms": busy, "pipe_ms": pipe, "bubble": 1.0 - busy / pipe,
                    "replicas_equal": cs.replicas_equal(model.leaves())}
    del model, state, step
    torch.cuda.empty_cache()

    # sequence parallelism over the four cards
    mesh = create_mesh()
    _warm(mesh)
    model, held, kw = cs.scoring_model(device)
    res["scoring"] = cs.score_modes(model, mesh, held, kw)
    group = mesh.axis_group("data")
    b, h, s_local, d = cs.HOP
    gen = torch.Generator(device=device).manual_seed(rank)
    k, v = (torch.randn((b, h, s_local, d), generator=gen, device=device, dtype=torch.bfloat16)
            for _ in range(2))
    hop = _event_ms(lambda: shift([k, v], group))
    a2a = _event_ms(lambda: all_to_all_cat(k, group, 1, 2))
    hop_bytes = 2 * k.numel() * k.element_size()
    res["comm"] = {"hop_bytes": hop_bytes, "hop_ms": hop[len(hop) // 2], "hop_ms_all": hop,
                   "hop_gb_per_s": hop_bytes / (hop[len(hop) // 2] * 1e-3) / 1e9,
                   "all_to_all_bytes": k.numel() * k.element_size(),
                   "all_to_all_ms": a2a[len(a2a) // 2], "all_to_all_ms_all": a2a}
    ring = model.replace(seq_mode="ring", mesh=mesh)
    window = torch.from_numpy(
        held[: cs.SCORE_BATCH * (cs.SCORE_SEQ + 1)].reshape(cs.SCORE_BATCH, -1)).to(device)
    optimizer = make_optimizer(cs.TRAIN_LR)
    state = optimizer.init(ring.leaves())
    step = make_train_step(optimizer, logit_chunk=cs.SCORE_CHUNK)
    ring, state, _ = step(ring, state, window)  # the first step warms the allocator
    cs._zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring, state, loss = step(ring, state, window)
    torch.cuda.synchronize()
    res["ring_train"] = {"loss": float(loss), "launches": cs._counts(),
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "replicas_equal": cs.replicas_equal(ring.leaves())}
    return res


def serving_part(device, out_dir: str) -> dict:
    """Part 9 on this rank: TP (1, 4) serving over NCCL."""
    import numpy as np

    from keystone_tpu_torch.models.lm import shard_params
    from keystone_tpu_torch.parallel import create_mesh, multihost

    # every rank replays the same graphs under the profiler: a rank that
    # took a session again would replay collectives the others do not
    cs.TRACE_ATTEMPTS = 1
    mesh = create_mesh(data=1, model=PROCS)
    _warm(mesh)
    f32 = cs.shard_f32_legs(device, mesh)
    if multihost.process_index() == 0:
        torch.save({k: f32[k].cpu() for k in ("float", "int8")},
                   os.path.join(out_dir, "shard_f32.pt"))
    res = {"f32": {"codes_equal": f32["codes_equal"], "launches": f32["launches"]}}
    del f32
    torch.cuda.empty_cache()
    model = shard_params(cs.shard_model(device, cs.LM_CONF["depth"], "bfloat16"), mesh)
    leg, loop, state, outs = cs.shard_loop_leg(device, model, cs.shard_prompts())
    leg["step_ms"] = cs._step_ms(loop, state, loop._tok.copy())
    leg["tokens_equal_ranks"] = cs.replicas_equal([torch.from_numpy(np.concatenate(outs))])
    res["bf16"] = leg
    return res


def check_serving(ranks: list, out_dir: str, ref: dict) -> dict:
    """Hold and print part 9 of every rank against the one-process
    reference on card 0."""
    depth = cs.LM_CONF["depth"]
    saved = {k: v.to(ref[k].device)
             for k, v in torch.load(os.path.join(out_dir, "shard_f32.pt")).items()}
    f32 = cs.check_shard_f32(f"TP (1, {PROCS}) serving f32 depth {cs.SHARD_F32_DEPTH}",
                             {**ranks[0]["f32"], **saved}, ref, 1)
    for r, par in enumerate(ranks):
        cs.check(par["f32"]["codes_equal"], f"rank {r}: the sharded quantization differs")
        cs.check(par["f32"]["launches"] == ranks[0]["f32"]["launches"],
                 f"rank {r}: f32 leg launches {par['f32']['launches']}")
        b = par["bf16"]
        print(f"  rank {r} TP serving bf16 depth {depth}: graphed {b['graphed']}; "
              f"{b['tokens']} tokens in {b['wall_s']:.3f} s ({b['tokens_per_s']:.1f} tokens/s); "
              f"pooled step {b['step_ms']:.3f} ms; launches a step replay "
              f"{b.get('step_launches')}, a prefill replay {b.get('prefill_launches')}; K4 "
              f"pieces {b['k4_pieces']}, on quantization.mm {b['pieces_on_mm']}; peak "
              f"{b['peak_bytes'] / 2**30:.2f} GiB")
        cs.check(b["tokens_equal_ranks"], "TP serving: the ranks' tokens differ")
        cs.check(b["k4_pieces"] == 6 * depth - len(b["pieces_on_mm"]), f"rank {r}: K4 pieces")
        if b["graphed"]:
            cs.check(b["step_launches"]["int8_matmul"] == b["k4_pieces"],
                     f"rank {r}: a step replay launched {b['step_launches']}")
            cs.check(b["prefill_launches"]["flash_attention"] == depth,
                     f"rank {r}: a prefill replay launched {b['prefill_launches']}")
    return {"f32": f32, "ranks": [p["bf16"] for p in ranks]}


def last_paths_part(device, out_dir: str) -> dict:
    """Part 10 on this rank."""
    from keystone_tpu_torch.models import mnist_random_fft
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.parallel import create_mesh, multihost, process_mesh

    rank = multihost.process_index()
    res = {"weighted": cs.weighted_rank_leg(device, out_dir, WEIGHTED)}

    mesh = create_mesh(data=2, model=PROCS // 2)
    _warm(mesh)
    coords = mesh.coords()
    weights: list = []
    undo = cs._capture_weights(weights)
    os.environ.update(KEYSTONE_PLAN="1", KEYSTONE_GRAM_OP="int8")
    gram.INT8_GRAM.launches = 0
    try:
        run = mnist_random_fft.main(list(cs.MAIN_ARGV), mesh=mesh)
    finally:
        undo()
    lo, hi = multihost.row_block(run["n_train"], coords["data"], mesh.shape["data"])
    rows = min(hi, run["n_train"]) - lo
    rank_chunk = run["fit_chunk_size"] // mesh.shape["data"]
    res["mnist"] = {"coords": [coords["data"], coords["model"]],
                    "k1_launches": gram.INT8_GRAM.launches, "rows": rows,
                    "rank_chunk": rank_chunk, "fit_chunks": -(-rows // rank_chunk),
                    "weights_equal": cs.replicas_equal(weights[-1:]),
                    **{k: run[k] for k in ("train_error", "test_error", "fit_s", "total_s",
                                           "processes", "fit_chunk_size")}}
    if rank == 0:
        torch.save({"pred": torch.from_numpy(run["test_predictions"])},
                   os.path.join(out_dir, "mnist_data_model.pt"))
    del run
    torch.cuda.empty_cache()

    mesh = process_mesh(PPTP_AXES)
    _warm(mesh)
    res["pptp"] = cs.dist_f32_leg(device, mesh, out_dir, "pptp", pp=PPTP_KW)
    torch.cuda.empty_cache()
    res["pptp_bf16"] = pptp_bf16_leg(device, mesh)
    res["pptp_bf16"]["coords"] = [mesh.coords()[a] for a in PPTP_AXES]
    return res


def pptp_bf16_leg(device, mesh) -> dict:
    """Three pp × tp train steps of the bf16 model at the flagship width
    after one that warms them: losses, K2, ms a step, peak memory and
    whether every replica holds the same parameters."""
    from keystone_tpu_torch.models.lm import (
        make_optimizer,
        make_pp_train_step,
        shard_params,
        unshard_params,
    )
    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus

    corpus = synthetic_corpus(200_000, cs.TRAIN_CONF["vocab"], seed=0)
    batches = [torch.from_numpy(_step_batch(corpus, 0, i, cs.TRAIN_BATCH, cs.TRAIN_SEQ)).to(device)
               for i in range(STEPS + 1)]
    model = shard_params(cs._par_model(device, cs.TRAIN_CONF["depth"], "bfloat16"), mesh)
    optimizer = make_optimizer(cs.TRAIN_LR, steps=STEPS + 1)
    state = optimizer.init(model.leaves())
    step = make_pp_train_step(optimizer, mesh, **PPTP_KW)
    model, state, _ = step(model, state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs._zero_counts()
    t0 = time.perf_counter()
    losses = []
    for toks in batches[1:]:
        model, state, loss = step(model, state, toks)
        losses.append(float(loss))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"losses": losses, "launches": cs._counts(), "ms_per_step": wall * 1e3 / STEPS,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "replicas_equal": cs.replicas_equal(unshard_params(model).leaves())}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def check_last_paths(ranks: list, out_dir: str, weighted_refs: dict, res8: dict,
                     par_ref: dict, par_floor: tuple) -> dict:
    """Hold and print part 10 of every rank."""
    saved = torch.load(os.path.join(out_dir, "weighted.pt"))
    weighted = cs.check_weighted_ranks(WEIGHTED, [r["weighted"] for r in ranks], weighted_refs,
                                       saved)
    depth = cs.TRAIN_CONF["depth"]
    k2_step = depth // PPTP_AXES["pipe"] * PPTP_KW["n_micro"]
    rows = {}
    for r, part in enumerate(ranks):
        m = part["mnist"]
        print(f"  rank {r} at (data, model) {tuple(m['coords'])}: MNIST int8 {m['rows']} rows, K1 "
              f"{m['k1_launches']} for {m['fit_chunks']} fit chunks of {m['rank_chunk']}, test "
              f"error {m['test_error']:.4%}, fit {m['fit_s']:.2f} s, run {m['total_s']:.2f} s")
        cs.check(m["processes"] == PROCS and m["k1_launches"] == m["fit_chunks"],
                 f"rank {r}: MNIST over (data, model) {m}")
        cs.check(m["test_error"] <= cs.MAX_TEST_ERROR and m["weights_equal"],
                 f"rank {r}: MNIST over (data, model) {m}")
        rows.setdefault(m["coords"][0], set()).add(m["rows"])
        b = part["pptp_bf16"]
        print(f"  rank {r} at (pipe, data, model) {tuple(b['coords'])}: pp x tp bf16 depth "
              f"{depth}: {b['ms_per_step']:.1f} ms a step, peak {b['peak_bytes'] / 2**30:.2f} GiB, "
              f"K2 {b['launches']['flash_attention']}, losses {b['losses']}")
        cs.check(b["launches"]["flash_attention"] == k2_step * STEPS,
                 f"rank {r} pp x tp bf16 K2 {b['launches']} for {k2_step} a step")
        cs.check(all(math.isfinite(x) for x in b["losses"]) and b["losses"][-1] < b["losses"][0],
                 f"rank {r} pp x tp bf16 losses {b['losses']}")
        cs.check(b["replicas_equal"], "pp x tp bf16: parameters differ across ranks")
    cs.check(all(len(v) == 1 for v in rows.values())
             and sum(next(iter(v)) for v in rows.values()) == res8["n_train"],
             f"MNIST over (data, model): rows {rows}")
    pred = torch.load(os.path.join(out_dir, "mnist_data_model.pt"))["pred"].numpy()
    agree = float((pred == res8["test_predictions"]).mean())
    print(f"  MNIST int8 over (data 2, model 2) against one process: test predictions agree on "
          f"{agree:.4%}")
    cs.check(agree >= cs.MIN_AGREEMENT, f"MNIST over (data, model): agreement {agree:.4%}")
    pp_f32 = cs.check_par_leg(
        f"pp x tp (2, 1, 2) f32 depth {cs.PAR_F32_DEPTH} over {PROCS} cards",
        cs.load_dist_f32_leg(out_dir, "pptp", ranks,
                             cs.PAR_F32_DEPTH // PPTP_AXES["pipe"] * PPTP_KW["n_micro"]),
        par_ref, par_floor)
    return {"weighted": weighted, "mnist_agreement": agree, "pptp_f32": pp_f32,
            "ranks": [{k: part[k] for k in ("mnist", "pptp_bf16")} for part in ranks]}


def worker(out_dir: str) -> None:
    """One process of the four: NCCL on card ``rank``."""
    from keystone_tpu_torch.models import mnist_random_fft
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.parallel import multihost

    device = multihost.initialize()
    rank, world = multihost.process_index(), multihost.process_count()
    res = {"rank": rank, "world": world, "device": str(device),
           "backend": torch.distributed.get_backend()}

    weights: list = []
    undo = cs._capture_weights(weights)
    os.environ.update(KEYSTONE_PLAN="1", KEYSTONE_GRAM_OP="int8")
    gram.INT8_GRAM.launches = 0
    try:
        run = mnist_random_fft.main(list(cs.MAIN_ARGV))
    finally:
        undo()
    lo, hi = multihost.row_block(run["n_train"])
    rows = min(hi, run["n_train"]) - lo
    rank_chunk = run["fit_chunk_size"] // world
    res["mnist"] = {"k1_launches": gram.INT8_GRAM.launches, "rows": rows,
                    "rank_chunk": rank_chunk, "fit_chunks": -(-rows // rank_chunk),
                    **{k: run[k] for k in ("train_error", "test_error", "fit_s", "total_s",
                                           "processes", "fit_chunk_size")}}
    if rank == 0:
        torch.save({"pred": torch.from_numpy(run["test_predictions"]), "w": weights[-1]},
                   os.path.join(out_dir, "mnist.pt"))
    del run
    torch.cuda.empty_cache()

    res["f32"] = cs.dp_f32_leg(device, out_dir, rank)

    cs._dp_train(device, cs.TRAIN_CONF, "bfloat16", 1)  # the first step warms the allocator
    cs._zero_counts()
    model, losses, wall = cs._dp_train(device, cs.TRAIN_CONF, "bfloat16", STEPS)
    res["bf16"] = {"losses": losses, "launches": cs._counts(), "ms_per_step": wall * 1e3 / STEPS,
                   "peak_bytes": torch.cuda.max_memory_allocated()}

    # one all-reduce of the gradients' size, as the step's buckets do it
    n = sum(p.numel() for p in model.leaves())
    del model
    torch.cuda.empty_cache()
    flat = torch.ones(n, dtype=torch.float32, device=device)
    for _ in range(3):
        multihost.all_reduce_(flat)
    torch.cuda.synchronize()
    times = []
    for _ in range(ALLREDUCE_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        multihost.all_reduce_(flat)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    ms = times[len(times) // 2]
    nbytes = 4 * n
    res["allreduce"] = {"elements": n, "bytes": nbytes, "ms": ms,
                        "bus_gb_per_s": 2 * (world - 1) / world * nbytes / (ms * 1e-3) / 1e9,
                        "ms_all": times}
    del flat
    torch.cuda.empty_cache()
    res["parallel"] = parallel_parts(device, out_dir)
    torch.cuda.empty_cache()
    res["serving"] = serving_part(device, out_dir)
    torch.cuda.empty_cache()
    res["last_paths"] = last_paths_part(device, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()


def check_parallel(ranks: list) -> dict:
    """Hold and print parts 4-8 of every rank."""
    depth = cs.TRAIN_CONF["depth"]
    forwards = -(-cs.SCORE_WINDOWS // cs.SCORE_BATCH)
    s_stages = PROCS
    predicted = (s_stages - 1) / (s_stages - 1 + PP_MICRO)
    for r, par in enumerate(ranks):
        for tag in ("tp", "dptp"):
            b = par[tag]["bf16"]
            print(f"  rank {r} {tag} bf16 depth {depth}: {b['ms_per_step']:.1f} ms a step, peak "
                  f"{b['peak_bytes'] / 2**30:.2f} GiB, K2 {b['launches']['flash_attention']}, "
                  f"losses {b['losses']}")
            cs.check(b["launches"]["flash_attention"] == depth * STEPS,
                     f"rank {r} {tag} bf16 K2 {b['launches']}")
            cs.check(all(math.isfinite(x) for x in b["losses"]) and b["losses"][-1] < b["losses"][0],
                     f"rank {r} {tag} bf16 losses {b['losses']}")
            cs.check(b["replicas_equal"], f"{tag} bf16: parameters differ across ranks")
        g = par["gpipe"]
        print(f"  rank {r} GPipe {s_stages} stages bf16 depth {depth}, n_micro {PP_MICRO}: "
              f"{g['ms_per_step']:.1f} ms a step, K2 {g['launches']['flash_attention']}, bubble "
              f"{g['bubble']:.3f} measured ({g['stage_busy_ms']:.1f} ms of stage work in "
              f"{g['pipe_ms']:.1f} ms of pipe) against {predicted:.3f} predicted")
        cs.check(g["launches"]["flash_attention"] == depth // s_stages * PP_MICRO * STEPS,
                 f"rank {r} GPipe K2 {g['launches']}")
        cs.check(all(math.isfinite(x) for x in g["losses"]), f"GPipe losses {g['losses']}")
        cs.check(g["replicas_equal"], "GPipe: parameters differ across ranks")
        for mode in ("ring", "ulysses"):
            sc = par["scoring"][mode]
            want = ({"flash_attention_step": forwards * depth * (r + 1)} if mode == "ring"
                    else {"flash_attention": forwards * depth})
            want = {k: want.get(k, 0) for k in sc["launches"]}
            print(f"  rank {r} {mode} scoring over {PROCS} cards: loss {sc['loss']:.6f}, "
                  f"{sc['ms_per_forward']:.1f} ms a forward, launches {sc['launches']}")
            cs.check(sc["launches"] == want, f"rank {r} {mode}: {sc['launches']} for {want}")
        c = par["comm"]
        print(f"  rank {r}: a ring hop of {c['hop_bytes'] / 1e6:.1f} MB {c['hop_ms']:.3f} ms "
              f"({c['hop_gb_per_s']:.1f} GB/s to the next card); all_to_all of "
              f"{c['all_to_all_bytes'] / 1e6:.1f} MB {c['all_to_all_ms']:.3f} ms")
        t = par["ring_train"]
        print(f"  rank {r} ring train step: loss {t['loss']:.6f}, {t['ms']:.1f} ms, launches "
              f"{t['launches']}")
        cs.check(math.isfinite(t["loss"]) and t["replicas_equal"], f"ring train step {t}")
        cs.check(t["launches"]["flash_attention_step"] == depth * (r + 1),
                 f"rank {r} ring train K3 {t['launches']}")
    for mode in ("ring", "ulysses"):
        losses = {p["scoring"][mode]["loss"] for p in ranks}
        cs.check(len(losses) == 1, f"{mode} scoring losses differ across ranks: {losses}")
    return {"gpipe_bubble_predicted": predicted, "ranks": ranks}


def main() -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < PROCS:
        sys.exit(f"chip_multicard: needs {PROCS} CUDA cards, "
                 f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        return
    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.core.runtime import resolve_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        print(f"card: {line}")
    t_all = time.perf_counter()
    device = resolve_device("cuda:0")
    cs.phase_build(cs._kernels())
    w8: list = []
    undo = cs._capture_weights(w8)
    try:
        res8 = cs.run_main("int8")
    finally:
        undo()
    ref = cs.f32_reference(device, PROCS)
    par_ref, par_floor = cs.par_reference(device, cs.PAR_F32_DEPTH)
    shard_ref = cs.shard_f32_reference(device)
    torch.cuda.empty_cache()
    weighted_refs = cs.weighted_references(device, WEIGHTED)

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("KEYSTONE_", "KST_"))}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out:
        t0 = time.perf_counter()
        sup = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch", "supervise", "--procs", str(PROCS),
             "--max-restarts", "0", "--grace", "5", "--",
             sys.executable, os.path.abspath(__file__), "--worker", out],
            cwd=root, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
        procs_s = time.perf_counter() - t0
        cs.check(sup.returncode == 0, f"supervise exit {sup.returncode}\n{sup.stderr[-4000:]}")
        ranks = []
        for r in range(PROCS):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        mnist = torch.load(os.path.join(out, "mnist.pt"))
        f32_saved = torch.load(os.path.join(out, "f32.pt"))
        par_ranks = [r["parallel"] for r in ranks]
        par_f32 = {tag: cs.check_par_leg(
            f"{label} f32 depth {cs.PAR_F32_DEPTH} over {PROCS} cards",
            cs.load_dist_f32_leg(out, tag, par_ranks, cs.PAR_F32_DEPTH), par_ref, par_floor)
            for tag, label in (("tp", "TP (1, 4)"), ("dptp", "dp x tp (2, 2)"))}
        serving = check_serving([r["serving"] for r in ranks], out, shard_ref)
        last_paths = check_last_paths([r["last_paths"] for r in ranks], out, weighted_refs,
                                      res8, par_ref, par_floor)

    print(f"four processes, one card each: {procs_s:.1f} s under the supervisor")
    want_k2 = cs.TRAIN_CONF["depth"] * STEPS
    for r in ranks:
        m, b, a = r["mnist"], r["bf16"], r["allreduce"]
        print(f"  rank {r['rank']}/{r['world']} on {r['device']} ({r['backend']}): MNIST "
              f"{m['rows']} rows, K1 {m['k1_launches']} for {m['fit_chunks']} fit chunks, test "
              f"error {m['test_error']:.4%}, fit {m['fit_s']:.2f} s; bf16 K2 "
              f"{b['launches']['flash_attention']}, {b['ms_per_step']:.1f} ms a step, losses "
              f"{b['losses']}; all-reduce of {a['bytes'] / 1e6:.1f} MB {a['ms']:.3f} ms, "
              f"{a['bus_gb_per_s']:.1f} GB/s bus")
        cs.check(r["backend"] == "nccl" and r["device"] == f"cuda:{r['rank']}", f"rank {r}")
        cs.check(m["processes"] == PROCS, f"rank {r['rank']}: {m['processes']} processes")
        cs.check(m["k1_launches"] == m["fit_chunks"], f"rank {r['rank']}: K1 "
                 f"{m['k1_launches']} for {m['fit_chunks']} fit chunks")
        cs.check(m["test_error"] <= cs.MAX_TEST_ERROR, f"test error {m['test_error']}")
        cs.check(b["launches"]["flash_attention"] == want_k2, f"K2 {b['launches']}")
        cs.check(all(math.isfinite(x) for x in b["losses"]) and b["losses"][-1] < b["losses"][0],
                 f"rank {r['rank']}: bf16 losses {b['losses']}")
    cs.check(sum(r["mnist"]["rows"] for r in ranks) == res8["n_train"], "rows split")
    agree = float((mnist["pred"].numpy() == res8["test_predictions"]).mean())
    w_dist = float((mnist["w"] - w8[-1]).abs().max() / w8[-1].abs().max())
    print(f"  MNIST int8, four processes against one: test predictions agree on {agree:.4%}, "
          f"weights {w_dist:.3e} of max|W| apart")
    cs.check(agree >= cs.MIN_AGREEMENT, f"agreement {agree:.4%}")
    f32 = cs.check_f32_leg(ref, [r["f32"]["losses"] for r in ranks], f32_saved["leaves"],
                           f32_saved["grads"], PROCS)
    parallel = check_parallel(par_ranks)
    parallel["f32"] = par_f32
    summary = {"cards": smi, "backend": "nccl", "procs_s": procs_s, "parallel": parallel,
               "one_process": {"mnist_fit_s": res8["fit_s"], "mnist_test_error":
                               res8["test_error"]},
               "serving": serving, "last_paths": last_paths,
               "ranks": [{k: v for k, v in r.items()
                          if k not in ("parallel", "serving", "last_paths")} for r in ranks],
               "mnist_agreement": agree, "mnist_weight_dist": w_dist,
               "f32": f32,
               "s": time.perf_counter() - t_all}
    print(json.dumps({"multicard": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
