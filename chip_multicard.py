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
   buffer): ms and bus GB/s (2·(n−1)/n of the bytes a rank sends).

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
TIMEOUT_S = 900


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
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()


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
    summary = {"cards": smi, "backend": "nccl", "procs_s": procs_s,
               "one_process": {"mnist_fit_s": res8["fit_s"], "mnist_test_error":
                               res8["test_error"]},
               "ranks": ranks, "mnist_agreement": agree, "mnist_weight_dist": w_dist,
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
