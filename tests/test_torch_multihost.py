"""keystone_tpu_torch's multi-process layer against the JAX package's,
over gloo on the CPU: data parallelism, and tensor, pipeline and sequence
parallelism across processes.

Two processes of the port form a ``torch.distributed`` group through
``parallel.multihost.initialize``, each holding its half of the rows, and
their results are held against the JAX package's one-process results: the
block least-squares fit (within 2e-4, ``tests/test_multihost.py:74``), the
flagship train step and ``train`` (losses within 1e-5, weights within
5e-5), a crash and resume through coordinated checkpoints (5e-5), the
fit-state merge (1e-6 relative), ``assemble_global``, the metrics roll-up
and ``merge_metric_dumps`` (exact).

Four processes (``tp``) hold dp × tp on a (2, 2) mesh and TP on (1, 4)
against the JAX package's unsharded ``build_tp()`` run
(``tests/test_multihost.py:182``: losses 1e-5, ``wq`` and ``embed``
5e-5), the dp × pp forward against the plain chain (2e-4), a dp × pp train
step against the local step (loss 1e-5, weights 5e-4,
``tests/test_lm_transformer.py:449``) and a TP model's perplexity. Two
processes (``sp``) hold ring and Ulysses attention, causal and not,
against dense attention (2e-4, ``tests/test_multihost.py:102``), ring and
Ulysses train steps against the JAX local step (as ``:182``), their
perplexity, and a TP run stopped after two checkpointed steps and resumed
to four against the JAX package's four (5e-5). Two processes (``serve``)
serve a model sharded over a model axis across them, dense and MoE:
``generate`` (an int8 KV cache too) and ``export_lm(quantize=True)``'s
slot pool give the JAX package's sharded tokens on both ranks, and
``quantize_for_decode`` of the shards, gathered, equals the JAX package's
quantization bit for bit (the row-split ``wo``/``w2`` take their scales'
max over the axis).

The worker is this file: ``python test_torch_multihost.py <mode> <rank>
<world> <port> <out>`` imports only torch and the port. The JAX reference
runs in the test process. Each spawned group has its own time limit, after
which every child is killed and the test fails. One group a mode runs
every layout: spawning the processes is the cost.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the reference test's data and model (tests/test_multihost.py:74,
# tests/_lm_worker_common.py)
FIT_N, FIT_D, FIT_C = 256, 24, 4
LM_BATCH, LM_SEQ, LM_STEPS, LM_LR, LM_VOCAB = 8, 32, 3, 1e-3, 31
TRAIN_SEED = 3
MNIST_ARGV = ["--synthetic", "600", "--num-ffts", "2", "--block-size", "512"]
# the streamed fit's chunk: one process folds the same 150-row chunks that
# two processes fold as their halves, so the int8 codes (scaled per chunk)
# are the same
MNIST_FIT_CHUNK = 150
MERGE_ROWS = (40, 25)
# the class-weighted fit over GlobalRows: one class holds 85 % of the rows
# (tests/test_torch_weighted.py's masked cases), so the reference's own
# one-process fit takes the masked layout too
WEIGHTED = dict(n=512, d=64, c=6, dominant=0.85)
WEIGHTED_EST = dict(block_size=32, num_iter=2, lam=0.1, mixture_weight=0.5, class_chunk=4)
# the streamed fit forced onto its materialized fallback (a memory budget
# below its state), against the fused fit of the same chain
FALLBACK_EST = dict(block_size=8, num_iter=3, lam=0.1)
FALLBACK_WIDTH = 20
TP_PROCS = 4
# held-out scoring (tests/test_torch_perplexity.py's shape, the LM's vocab)
EVAL_SEQ, EVAL_BATCH, EVAL_CHUNK = 32, 2, 16
ATTN_SHAPE = (2, 4, 128, 16)
# serving a sharded model (tests/test_torch_tp_serve.py's tiny models)
SERVE_CONF = dict(vocab=64, max_seq=48, dim=64, depth=2, num_heads=4)
SERVE_MOE = dict(moe_every=2, num_experts=4)
SERVE_NEW = 10
SERVE_LOOP = dict(slots=2, s_max=32, max_new=6)
SERVE_LOOP_LENS = (5, 9, 3)
SERVE_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")


def _fit_data():
    rng = np.random.default_rng(0)
    cls = rng.integers(0, FIT_C, size=FIT_N)
    centers = rng.normal(size=(FIT_C, FIT_D)).astype(np.float32) * 2
    data = (centers[cls] + rng.normal(size=(FIT_N, FIT_D))).astype(np.float32)
    labels = -np.ones((FIT_N, FIT_C), np.float32)
    labels[np.arange(FIT_N), cls] = 1.0
    return data, labels


def _weighted_data():
    """Class-clustered rows and ±1 indicators, ``WEIGHTED["dominant"]`` of
    them in class 0 (tests/test_torch_weighted.py's ``_data``)."""
    n, d, c = WEIGHTED["n"], WEIGHTED["d"], WEIGHTED["c"]
    rng = np.random.default_rng(17)
    cls = rng.integers(0, c, size=n)
    cls[: int(WEIGHTED["dominant"] * n)] = 0
    rng.shuffle(cls)
    centers = rng.normal(size=(c, d)) * 2
    a = (centers[cls] + rng.normal(size=(n, d))).astype(np.float32)
    y = -np.ones((n, c), np.float32)
    y[np.arange(n), cls] = 1.0
    return a, y


def _fallback_chain(seen: list):
    """A chained block fit behind a row-wise featurizer (cos of a fixed
    projection) that logs the rows of every batch it featurizes."""
    import torch

    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, transformer
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator

    proj = torch.from_numpy(
        np.random.default_rng(23).normal(size=(FIT_D, FALLBACK_WIDTH)).astype(np.float32))

    def cos_features(x):
        seen.append(int(x.shape[0]))
        return torch.cos(x @ proj.to(x.device))

    return ChainedLabelEstimator(prefix=transformer(cos_features),
                                 est=BlockLeastSquaresEstimator(**FALLBACK_EST))


def _merge_chunk(rank: int):
    rng = np.random.default_rng(100 + rank)
    n = MERGE_ROWS[rank]
    return (rng.normal(size=(n, 16)) + rank).astype(np.float32), rng.normal(size=(n, 3)).astype(
        np.float32)


def _assemble_inputs(rank: int):
    """(features, labels) per rank for two gathers: an empty rank with
    (0, 0) features, then unequal ranks."""
    rng = np.random.default_rng(7 + rank)
    empty = ((rng.normal(size=(3, 4)).astype(np.float32), np.arange(3, dtype=np.int32))
             if rank == 0 else (np.zeros((0, 0), np.float32), np.zeros((0,), np.int32)))
    n = (2, 5)[rank]
    unequal = (rng.normal(size=(n, 4)).astype(np.float32),
               np.arange(n, dtype=np.int32) + 10 * rank)
    return empty, unequal


# --------------------------------------------------------------- workers


def _w_fit(rank, world, out: Path) -> None:
    """The fit, the fit-state merge, assemble_global, the metrics roll-up
    and the MNIST run across the group."""
    import torch

    from keystone_tpu_torch.learn.merge import allmerge_fit_state
    from keystone_tpu_torch.loaders.imagenet_stream import assemble_global
    from keystone_tpu_torch.models import mnist_random_fft
    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.ops.linear import (
        BlockLeastSquaresEstimator,
        normal_eq_init,
        normal_eq_update,
    )
    from keystone_tpu_torch.parallel import create_mesh, multihost, shard_batch

    res: dict = {}
    data, labels = _fit_data()
    lo, hi = rank * FIT_N // world, (rank + 1) * FIT_N // world
    g_data = multihost.global_batch_from_local(data[lo:hi])
    g_labels = multihost.global_batch_from_local(labels[lo:hi])
    assert (g_data.n_global, g_data.offset) == (FIT_N, lo), g_data
    model = BlockLeastSquaresEstimator(block_size=7, num_iter=3, lam=0.1).fit(g_data, g_labels)
    w = torch.cat(list(model.xs))
    res["fit_x"] = w.numpy()
    res["fit_b"] = model.b.numpy()
    # the weights come out the same on every process
    res["fit_replicas_equal"] = all(torch.equal(w, o) for o in multihost.all_gather(w))

    a, b = _merge_chunk(rank)
    state = normal_eq_update(normal_eq_init(16, 3, "cpu"), torch.from_numpy(a), torch.from_numpy(b))
    merged = allmerge_fit_state(state)
    for name in ("ata", "atb", "mean_a", "mean_b", "n"):
        res[f"merge_{name}"] = getattr(merged, name).numpy()

    for tag, (f, y) in zip(("empty", "unequal"), _assemble_inputs(rank)):
        gf, gy = assemble_global(f, y)
        res[f"assemble_{tag}_f"], res[f"assemble_{tag}_y"] = gf, gy

    reg = metrics.get_registry()
    reg.counter("mh_rows").inc(100 * (rank + 1))
    reg.counter("mh_calls", host=str(rank)).inc(rank + 1)
    reg.gauge("mh_hbm_peak").set(float(1000 * (rank + 1)))
    t = reg.timer("mh_step_seconds")
    for k in range(10):
        t.observe(0.010 * (rank + 1) + 0.001 * k)
    rolled = multihost.rollup_metrics(str(out))
    res["rollup_on_rank"] = rolled is not None

    from keystone_tpu_torch import plan as plan_mod
    from keystone_tpu_torch.plan import fused_fit

    fused_fit._DEFAULT_FIT_CHUNK = MNIST_FIT_CHUNK
    mesh = create_mesh()
    res["mesh_data"] = mesh.shape["data"]
    rows = shard_batch(np.arange(10, dtype=np.float32).reshape(5, 2), mesh)
    res["shard_local"] = rows.local.numpy()
    res["shard_layout"] = np.array([rows.n_global, rows.offset, rows.n_valid])
    res["shard_gather"] = rows.gather().numpy()
    res["plan_shards"] = plan_mod._shards(plan_mod.Plan(prefix=[], mesh=mesh))

    # the class-weighted fit of a global batch: each process's half
    from keystone_tpu_torch.ops.weighted_linear import BlockWeightedLeastSquaresEstimator

    wa, wy = _weighted_data()
    w_lo, w_hi = rank * len(wa) // world, (rank + 1) * len(wa) // world
    t0 = time.perf_counter()
    wmodel = BlockWeightedLeastSquaresEstimator(**WEIGHTED_EST).fit(
        multihost.global_batch_from_local(wa[w_lo:w_hi]), torch.from_numpy(wy[w_lo:w_hi]))
    res["weighted_s"] = time.perf_counter() - t0
    res["weighted_x"] = torch.cat(list(wmodel.xs)).numpy()
    res["weighted_b"] = wmodel.b.numpy()
    res["weighted_equal"] = _replicas_equal([*wmodel.xs, wmodel.b])

    # fit_streaming's materialized fallback under the process mesh: each
    # process featurizes its row block only
    from keystone_tpu_torch.observe import metrics as _m

    seen: list = []
    chain = _fallback_chain(seen)
    fused, fused_plan = plan_mod.fit_streaming(chain, data, labels, device=torch.device("cpu"),
                                               mesh=mesh, return_plan=True)
    rows_before = _m.get_registry().counter("plan_fit_materialized_rows").value
    fell, fell_plan = plan_mod.fit_streaming(chain, data, labels, device=torch.device("cpu"),
                                             mesh=mesh, budget_bytes=1, return_plan=True)
    res["fallback_fused"] = fused_plan.fit.fused and not fell_plan.fit.fused
    res["fallback_reason"] = fell_plan.decision("fit_fallback")["reason"]
    res["fallback_rows"] = np.array(multihost.all_gather_meta(torch.tensor(
        [seen[-1], _m.get_registry().counter("plan_fit_materialized_rows").value - rows_before]
    ))).reshape(world, 2)
    res["fallback_w"] = torch.cat(list(fell[-1].xs)).numpy()
    res["fused_w"] = torch.cat(list(fused[-1].xs)).numpy()
    for tag, env in (("classic", {}), ("streamed", {"KEYSTONE_PLAN": "1",
                                                    "KEYSTONE_GRAM_OP": "int8"})):
        os.environ.update(env)
        with _finalized() as weights:
            r = mnist_random_fft.main(MNIST_ARGV, device="cpu")
        for k in env:
            os.environ.pop(k)
        res[f"mnist_{tag}_w"] = weights[-1]
        res[f"mnist_{tag}_pred"] = r["test_predictions"]
        res[f"mnist_{tag}_err"] = np.array([r["train_error"], r["test_error"]])
        res[f"mnist_{tag}_procs"] = r["processes"]
    _save(out, rank, res)


def _finalized():
    """A context collecting the weights (D, K) of every model the block
    solver finalizes from normal-equation statistics."""
    import contextlib

    import torch

    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator

    @contextlib.contextmanager
    def ctx():
        real, out = BlockLeastSquaresEstimator._finalize, []

        def finalize(self, *a, **kw):
            models = real(self, *a, **kw)
            out.append(torch.cat(list(models[-1].xs)).numpy())
            return models

        BlockLeastSquaresEstimator._finalize = finalize
        try:
            yield out
        finally:
            BlockLeastSquaresEstimator._finalize = real

    return ctx()


def _lm_model(out: Path, name: str = "lm_in.npz", **kw):
    from keystone_tpu_torch import convert

    z = np.load(out / name)
    meta = json.loads(str(z["meta"]))
    leaves = {
        "embed": z["embed"],
        "pos_embed": z["pos_embed"],
        "blocks": [
            {n: z[f"b{i}_{n}"] for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
            for i in range(meta["depth"])
        ],
    }
    return convert.transformer_lm(leaves, num_heads=meta["num_heads"], device="cpu", **kw)


def _serve_prompts():
    """(a (2, 8) generate prompt, the slot pool's prompts)."""
    rng = np.random.default_rng(21)
    return (rng.integers(0, SERVE_CONF["vocab"], size=(2, 8)),
            [rng.integers(0, SERVE_CONF["vocab"], size=n) for n in SERVE_LOOP_LENS])


def _serve_model(out: Path, name: str):
    """The port's model ``name`` (dense or moe) from ``lm_serve_in.npz``."""
    from keystone_tpu_torch import convert

    z = np.load(out / "lm_serve_in.npz")
    depth = SERVE_CONF["depth"]
    leaves = {
        "embed": z[f"{name}_embed"], "pos_embed": z[f"{name}_pos_embed"],
        "blocks": [{n: z[f"{name}_b{i}_{n}"] for n in SERVE_WEIGHTS} for i in range(depth)],
        "moe_layers": [
            dict(w_router=z[f"{name}_m{i}_w_router"], w1=z[f"{name}_m{i}_w1"],
                 w2=z[f"{name}_m{i}_w2"], capacity_factor=float(z[f"{name}_m{i}_cf"]),
                 group_size=int(z[f"{name}_m{i}_gs"]))
            if f"{name}_m{i}_w_router" in z else None
            for i in range(depth)] if name == "moe" else [],
    }
    return convert.transformer_lm(leaves, num_heads=SERVE_CONF["num_heads"], device="cpu")


def _held_out():
    from keystone_tpu_torch.models.lm.train import synthetic_corpus

    return synthetic_corpus(5 * (EVAL_SEQ + 1), LM_VOCAB, seed=7)


def _replicas_equal(tensors) -> bool:
    """True when ``tensors`` hash the same on every rank."""
    import hashlib

    import torch

    from keystone_tpu_torch.parallel import multihost

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    mine = torch.tensor([int.from_bytes(h.digest()[:7], "little")], dtype=torch.int64)
    return all(torch.equal(mine, o) for o in multihost.all_gather(mine))


def _lm_steps(model, step, state, rows=slice(None), steps: int = LM_STEPS) -> tuple:
    import torch

    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus

    corpus = synthetic_corpus(20_000, LM_VOCAB, seed=0)
    losses = []
    for i in range(steps):
        toks = np.ascontiguousarray(_step_batch(corpus, 0, i, LM_BATCH, LM_SEQ)[rows])
        model, state, loss = step(model, state, torch.from_numpy(toks))
        losses.append(float(loss))
    return model, losses


def _w_tp(rank, world, out: Path) -> None:
    """Four processes: dp × tp on (2, 2) and TP on (1, 4), three steps
    each; the dp × pp forward and one dp × pp train step on (2, 2); a TP
    model's perplexity; every replica's hash and the gather of the
    shards; row blocks, MNIST's fits and its evaluator over a (data 2,
    model 2) mesh; one pp × tp train step on (pipe 2, data 1, model 2)."""
    import torch

    from keystone_tpu_torch.evaluation import evaluate_perplexity
    from keystone_tpu_torch.models.lm import (
        make_optimizer,
        make_pp_train_step,
        make_train_step,
        pp_forward,
        shard_params,
        unshard_params,
    )
    from keystone_tpu_torch.models.lm.sharding import gather_leaf, leaf_dims, local_leaf
    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus
    from keystone_tpu_torch.parallel import create_mesh, multihost, process_mesh, shard_batch

    res: dict = {}
    for tag, (n_data, n_model) in (("dptp", (2, 2)), ("tp4", (1, 4))):
        mesh = create_mesh(data=n_data, model=n_model)
        coords = mesh.coords()
        res[f"{tag}_coords"] = np.array([coords["data"], coords["model"]])
        model = shard_params(_lm_model(out, "lm_tp_in.npz"), mesh)
        dims = leaf_dims(model)
        res[f"{tag}_roundtrip"] = all(
            torch.equal(local_leaf(model, gather_leaf(model, w, d), d), w)
            for w, d in zip(model.leaves(), dims))
        optimizer = make_optimizer(LM_LR, weight_decay=1e-4)
        step = make_train_step(optimizer, data_parallel=n_data > 1)
        rows = slice(*multihost.row_block(LM_BATCH, coords["data"], n_data))
        model, losses = _lm_steps(model, step, optimizer.init(model.leaves()), rows)
        whole = unshard_params(model)
        res[f"{tag}_losses"] = np.asarray(losses)
        res[f"{tag}_wq"] = whole.blocks[0].wq.detach().numpy()
        res[f"{tag}_embed"] = whole.embed.detach().numpy()
        res[f"{tag}_equal"] = _replicas_equal(whole.leaves())
        if tag == "tp4":
            fresh = shard_params(_lm_model(out, "lm_tp_in.npz"), mesh)
            res["tp4_ppl"] = np.array([
                evaluate_perplexity(fresh, _held_out(), seq=EVAL_SEQ, batch=EVAL_BATCH,
                                    logit_chunk=chunk)["loss"] for chunk in (0, EVAL_CHUNK)])

    mesh = create_mesh(data=2, model=2)
    corpus = synthetic_corpus(20_000, LM_VOCAB, seed=0)
    toks_pp = _step_batch(corpus, 0, 99, LM_BATCH, LM_SEQ)[:, :LM_SEQ]
    with torch.no_grad():
        res["pp"] = pp_forward(_lm_model(out, "lm_tp_in.npz"), torch.from_numpy(toks_pp), mesh,
                               n_micro=2, axis="model", data_axis="data").numpy()
    optimizer = make_optimizer(LM_LR, weight_decay=1e-4)
    model = _lm_model(out, "lm_tp_in.npz")
    step = make_pp_train_step(optimizer, mesh, n_micro=2, data_axis="data")
    model, losses = _lm_steps(model, step, optimizer.init(model.leaves()), steps=1)
    res["pp_step_loss"] = np.asarray(losses)
    res["pp_step_leaves"] = np.concatenate([t.detach().reshape(-1).numpy()
                                            for t in model.leaves()])
    res["pp_step_equal"] = _replicas_equal(model.leaves())

    _w_data_model(res, world)

    # pp × tp: two stages of two blocks, each stage's blocks split over a
    # model axis of two
    mesh = process_mesh({"pipe": 2, "data": 1, "model": 2})
    coords = mesh.coords()
    res["pptp_coords"] = np.array(multihost.all_gather_meta(torch.tensor(
        [coords["pipe"], coords["data"], coords["model"]]))).reshape(world, 3)
    optimizer = make_optimizer(LM_LR, weight_decay=1e-4)
    model = shard_params(_lm_model(out, "lm_tp_in.npz"), mesh)
    step = make_pp_train_step(optimizer, mesh, n_micro=2, axis="pipe", data_axis="data")
    model, losses = _lm_steps(model, step, optimizer.init(model.leaves()), steps=1)
    whole = unshard_params(model)
    res["pptp_step_loss"] = np.asarray(losses)
    res["pptp_step_leaves"] = np.concatenate([t.detach().reshape(-1).numpy()
                                              for t in whole.leaves()])
    res["pptp_equal"] = _replicas_equal(whole.leaves())
    _save(out, rank, res)


def _w_data_model(res: dict, world: int) -> None:
    """Row blocks over a (data 2, model 2) mesh across four processes, and
    MNIST's classic and streamed int8 fits with their evaluator over it."""
    import torch

    from keystone_tpu_torch.models import mnist_random_fft
    from keystone_tpu_torch.parallel import create_mesh, multihost, shard_batch
    from keystone_tpu_torch.plan import fused_fit

    mesh = create_mesh(data=2, model=2)
    coords = mesh.coords()
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    rows = shard_batch(x, mesh)
    # data row 0 passes 2 rows, data row 1 three: each model position of a
    # data row passes the same rows
    mine = x[:2] if coords["data"] == 0 else x[2:]
    assembled = multihost.global_batch_from_local(mine, mesh)
    res["dm_layout"] = np.array(multihost.all_gather_meta(torch.tensor(
        [coords["data"], coords["model"], rows.offset, rows.n_local, rows.n_valid,
         rows.n_global, assembled.offset, assembled.n_global]))).reshape(world, 8)
    res["dm_local"] = np.stack([t.numpy() for t in multihost.all_gather(rows.local)])
    res["dm_gather"] = rows.gather().numpy()
    res["dm_assembled"] = assembled.gather().numpy()

    fused_fit._DEFAULT_FIT_CHUNK = MNIST_FIT_CHUNK
    for tag, env in (("classic", {}), ("streamed", {"KEYSTONE_PLAN": "1",
                                                    "KEYSTONE_GRAM_OP": "int8"})):
        os.environ.update(env)
        with _finalized() as weights:
            r = mnist_random_fft.main(MNIST_ARGV, device="cpu", mesh=mesh)
        for k in env:
            os.environ.pop(k)
        res[f"dm_mnist_{tag}_w"] = weights[-1]
        res[f"dm_mnist_{tag}_pred"] = r["test_predictions"]
        res[f"dm_mnist_{tag}_err"] = np.array([r["train_error"], r["test_error"]])
        res[f"dm_mnist_{tag}_equal"] = _replicas_equal([torch.from_numpy(weights[-1])])


def _w_sp(rank, world, out: Path, ckdir: str) -> None:
    """Two processes: ring and Ulysses attention against dense; ring and
    Ulysses train steps and perplexity on the whole batch; a TP run on
    (1, 2) checkpointed and stopped after two steps, then resumed to
    four."""
    import torch

    from keystone_tpu_torch.core.checkpoint import read_step
    from keystone_tpu_torch.evaluation import evaluate_perplexity
    from keystone_tpu_torch.models.lm import (
        make_optimizer,
        make_train_step,
        shard_params,
        train,
        unshard_params,
    )
    from keystone_tpu_torch.models.lm.train import synthetic_corpus
    from keystone_tpu_torch.ops.attention import ring_attention, ulysses_attention
    from keystone_tpu_torch.parallel import create_mesh

    res: dict = {}
    mesh = create_mesh()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=ATTN_SHAPE).astype(np.float32))
               for _ in range(3))
    for causal in (False, True):
        res[f"ring_causal{causal}"] = ring_attention(q, k, v, mesh, causal=causal).numpy()
        res[f"ulysses_causal{causal}"] = ulysses_attention(q, k, v, mesh, causal=causal).numpy()

    for mode in ("ring", "ulysses"):
        model = _lm_model(out, seq_mode=mode, mesh=mesh)
        res[f"{mode}_ppl"] = np.array([
            evaluate_perplexity(model, _held_out(), seq=EVAL_SEQ, batch=EVAL_BATCH,
                                logit_chunk=chunk)["loss"] for chunk in (0, EVAL_CHUNK)])
        optimizer = make_optimizer(LM_LR, weight_decay=1e-4)
        model, losses = _lm_steps(model, make_train_step(optimizer),
                                  optimizer.init(model.leaves()))
        res[f"{mode}_losses"] = np.asarray(losses)
        res[f"{mode}_wq"] = model.blocks[0].wq.detach().numpy()
        res[f"{mode}_embed"] = model.embed.detach().numpy()
        res[f"{mode}_equal"] = _replicas_equal(model.leaves())

    corpus = synthetic_corpus(20_000, LM_VOCAB, seed=0)
    tp_mesh = create_mesh(data=1, model=2)
    kw = dict(batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR, seed=TRAIN_SEED, checkpoint_dir=ckdir,
              checkpoint_every=1)
    _, first = train(shard_params(_lm_model(out), tp_mesh), corpus, steps=2, mesh=tp_mesh, **kw)
    model, rest = train(shard_params(_lm_model(out), tp_mesh), corpus, steps=4, mesh=tp_mesh,
                        **kw)
    whole = unshard_params(model)
    saved, step = read_step(ckdir)
    res["ckpt_losses"] = np.asarray(first + rest)
    res["ckpt_wq"] = whole.blocks[0].wq.detach().numpy()
    res["ckpt_embed"] = whole.embed.detach().numpy()
    res["ckpt_step"] = step
    res["ckpt_whole_bits"] = all(torch.equal(a, b) for a, b in zip(saved, whole.leaves()))
    res["ckpt_equal"] = _replicas_equal(whole.leaves())
    _save(out, rank, res)


def _w_serve(rank, world, out: Path) -> None:
    """Two processes serve the dense and the MoE model sharded over a model
    axis across them: greedy ``generate`` (f32 and int8 KV cache), the
    slot pool of ``export_lm(quantize=True)``, and the quantized shards
    gathered back."""
    import torch

    from keystone_tpu_torch.models.lm import (
        generate,
        quantize_for_decode,
        shard_params,
        unshard_params,
    )
    from keystone_tpu_torch.models.lm.decode import cache_heads
    from keystone_tpu_torch.parallel import create_mesh
    from keystone_tpu_torch.serve.export import export_lm

    res: dict = {}
    mesh = create_mesh(data=1, model=world)
    prompt, loop_prompts = _serve_prompts()
    for name in ("dense", "moe"):
        model = shard_params(_serve_model(out, name), mesh)
        toks = generate(model, torch.from_numpy(prompt), max_new=SERVE_NEW)
        kv8 = generate(model, torch.from_numpy(prompt), max_new=SERVE_NEW, kv_dtype="int8")
        loop = export_lm(model, quantize=True, **SERVE_LOOP)
        outs = loop.run(loop_prompts)
        res[f"{name}_generate"], res[f"{name}_generate_kv8"] = toks.numpy(), kv8.numpy()
        res[f"{name}_loop"] = np.concatenate(outs)
        res[f"{name}_graphed"] = loop.graphed
        res[f"{name}_cache_heads"] = loop.cache.k.shape[2]
        res[f"{name}_local_heads"] = cache_heads(model)
        res[f"{name}_equal"] = _replicas_equal([toks, kv8, torch.from_numpy(res[f"{name}_loop"])])
    whole = _serve_model(out, "dense")
    gathered = unshard_params(quantize_for_decode(shard_params(whole, mesh)))
    mine = quantize_for_decode(whole)
    res["q_codes"] = np.concatenate([w.q.numpy().reshape(-1) for w in gathered.leaves()
                                     if hasattr(w, "q")])
    res["q_scales"] = np.concatenate([w.scale.numpy().reshape(-1) for w in gathered.leaves()
                                      if hasattr(w, "q")])
    res["q_whole_bits"] = all(
        torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        for a, b in zip(gathered.leaves(), mine.leaves()) if hasattr(a, "q"))
    _save(out, rank, res)


def _w_lm(rank, world, out: Path) -> None:
    """Three data-parallel steps of ``make_train_step`` with optax.adamw's
    defaults (``_lm_worker_common.build``), then three of ``train``."""
    import torch

    from keystone_tpu_torch.models.lm.train import (
        _step_batch,
        make_optimizer,
        make_train_step,
        synthetic_corpus,
        train,
    )
    from keystone_tpu_torch.parallel import multihost

    corpus = synthetic_corpus(20_000, LM_VOCAB, seed=0)
    model = _lm_model(out)
    optimizer = make_optimizer(LM_LR, weight_decay=1e-4)
    state = optimizer.init(model.leaves())
    step = make_train_step(optimizer, data_parallel=True)
    lo, hi = multihost.row_block(LM_BATCH)
    losses = []
    for i in range(LM_STEPS):
        toks = np.ascontiguousarray(_step_batch(corpus, 0, i, LM_BATCH, LM_SEQ)[lo:hi])
        model, state, loss = step(model, state, torch.from_numpy(toks))
        losses.append(float(loss))
    res = {"losses": np.asarray(losses), "wq": model.blocks[0].wq.detach().numpy(),
           "embed": model.embed.detach().numpy()}
    model2, losses2 = train(_lm_model(out), corpus, steps=LM_STEPS, batch=LM_BATCH, seq=LM_SEQ,
                            lr=LM_LR, seed=TRAIN_SEED)
    res.update(train_losses=np.asarray(losses2), train_wq=model2.blocks[0].wq.detach().numpy(),
               train_embed=model2.embed.detach().numpy())
    _save(out, rank, res)


def _w_ckpt(rank, world, out: Path, ckdir: str, phase: str) -> None:
    """The reference's crash-and-resume worker (tests/multihost_ckpt_worker.py):
    two coordinated-checkpointed steps, then a rerun to four."""
    import torch

    from keystone_tpu_torch.core.checkpoint import TrainCheckpointer
    from keystone_tpu_torch.models.lm.train import (
        _step_batch,
        _train_state,
        make_optimizer,
        make_train_step,
        synthetic_corpus,
    )
    from keystone_tpu_torch.parallel import multihost

    corpus = synthetic_corpus(20_000, LM_VOCAB, seed=0)
    model = _lm_model(out)
    optimizer = make_optimizer(LM_LR, weight_decay=1e-4)
    state = optimizer.init(model.leaves())
    step = make_train_step(optimizer, data_parallel=True)
    steps = 2 if phase == "crash" else 4
    ckpt = TrainCheckpointer(ckdir, {"kind": "mh_lm", "batch": LM_BATCH},
                             cluster_info={"num_processes": world})
    restored, start = ckpt.restore(_train_state(model, state))
    state.count = int(restored["count"])
    if phase == "resume":
        assert start == 2, f"resume found start={start}"
    lo, hi = multihost.row_block(LM_BATCH)
    for i in range(start, steps):
        toks = np.ascontiguousarray(_step_batch(corpus, 0, i, LM_BATCH, LM_SEQ)[lo:hi])
        model, state, _ = step(model, state, torch.from_numpy(toks))
        ckpt.save(_train_state(model, state), i + 1)
    if phase == "resume":
        _save(out, rank, {"wq": model.blocks[0].wq.detach().numpy(),
                          "embed": model.embed.detach().numpy()})


def _save(out: Path, rank: int, res: dict) -> None:
    if rank == 0:
        np.savez(out / "rank0.npz", **{k: np.asarray(v) for k, v in res.items()})


def _worker(argv: list) -> int:
    mode, rank, world, port, out = argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4])
    from keystone_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, init_timeout_s=30, device="cpu")
    try:
        if mode == "fit":
            _w_fit(rank, world, out)
        elif mode == "lm":
            _w_lm(rank, world, out)
        elif mode == "ckpt":
            _w_ckpt(rank, world, out, argv[5], argv[6])
        elif mode == "tp":
            _w_tp(rank, world, out)
        elif mode == "sp":
            _w_sp(rank, world, out, argv[5])
        elif mode == "serve":
            _w_serve(rank, world, out)
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    finally:
        multihost.shutdown()
    print(f"worker {rank}: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))


# ----------------------------------------------------------------- tests

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.learn.merge import fit_stats_merge as j_fit_stats_merge  # noqa: E402
from keystone_tpu.ops import linear as jlinear  # noqa: E402
from keystone_tpu.parallel import multihost as jmultihost  # noqa: E402
from keystone_tpu.parallel.mesh import create_mesh as jcreate_mesh  # noqa: E402
from keystone_tpu_torch.parallel import create_mesh  # noqa: E402
from keystone_tpu_torch.parallel import multihost  # noqa: E402

PAIR_LIMIT_S = 60.0
_ENV_KEYS = ("KEYSTONE_COORDINATOR", "KEYSTONE_PROCESS_ID", "KEYSTONE_NUM_PROCESSES")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(mode: str, out: Path, port: int, *extra, procs: int = 2) -> None:
    """Run one worker group of ``procs`` processes; every child is killed
    and the test fails when the group outlives ``PAIR_LIMIT_S``."""
    env = dict(os.environ)
    for key in _ENV_KEYS + ("KEYSTONE_PLAN", "KEYSTONE_GRAM_OP", "KEYSTONE_FAULTS",
                            "KEYSTONE_OBSERVE_DIR"):
        env.pop(key, None)
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2" if procs <= 2 else "1"
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, mode, str(r), str(procs), str(port), str(out),
             *map(str, extra)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(procs)
    ]
    deadline = time.monotonic() + PAIR_LIMIT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{mode} worker pair outlived {PAIR_LIMIT_S:.0f} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{mode} worker failed:\n{log}"


@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mh_fit")
    _spawn("fit", out, _free_port())
    return out, dict(np.load(out / "rank0.npz"))


def _jax_lm():
    """The JAX one-process model, optimizer, step and corpus
    (``_lm_worker_common.build``), built afresh: its train step donates
    the model's buffers."""
    from _lm_worker_common import build

    return build()


def _write_lm_in(out: Path, jm, name: str = "lm_in.npz") -> None:
    arrays = {"embed": np.asarray(jm.embed), "pos_embed": np.asarray(jm.pos_embed)}
    for i, blk in enumerate(jm.blocks):
        for n in ("wq", "wk", "wv", "wo", "w1", "w2"):
            arrays[f"b{i}_{n}"] = np.asarray(getattr(blk, n))
    meta = {"depth": len(jm.blocks), "num_heads": jm.num_heads}
    np.savez(out / name, meta=json.dumps(meta), **arrays)


def _jax_steps(steps: int):
    """tests/test_multihost.py:137 ``_single_process_lm_reference``."""
    from _lm_worker_common import step_batch

    model, optimizer, step, corpus = _jax_lm()
    opt_state = optimizer.init(model)
    losses = []
    for i in range(steps):
        model, opt_state, loss = step(model, opt_state, jnp.asarray(step_batch(corpus, i)))
        losses.append(float(loss))
    return model, losses


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    from _lm_worker_common import build_tp

    out = tmp_path_factory.mktemp("mh_tp")
    _write_lm_in(out, build_tp()[0], "lm_tp_in.npz")
    _spawn("tp", out, _free_port(), procs=TP_PROCS)
    return dict(np.load(out / "rank0.npz"))


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mh_sp")
    _write_lm_in(out, _jax_lm()[0])
    _spawn("sp", out, _free_port(), out / "tp_ck")
    return dict(np.load(out / "rank0.npz"))


def _jax_serve_models() -> dict:
    """tests/test_torch_tp_serve.py's dense and MoE models (routers scaled
    by 25)."""
    import dataclasses

    import jax

    from keystone_tpu.models import lm_transformer as jlm

    dense = jlm.TransformerLM.create(jax.random.key(0), **SERVE_CONF)
    moe = jlm.TransformerLM.create(jax.random.key(0), **SERVE_CONF, **SERVE_MOE)
    moe = dataclasses.replace(moe, moe_layers=tuple(
        None if m is None else dataclasses.replace(m, w_router=m.w_router * 25.0)
        for m in moe.moe_layers))
    return {"dense": dense, "moe": moe}


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mh_serve")
    arrays = {}
    for name, jm in _jax_serve_models().items():
        arrays[f"{name}_embed"] = np.asarray(jm.embed)
        arrays[f"{name}_pos_embed"] = np.asarray(jm.pos_embed)
        for i, blk in enumerate(jm.blocks):
            for n in SERVE_WEIGHTS:
                arrays[f"{name}_b{i}_{n}"] = np.asarray(getattr(blk, n))
        for i, m in enumerate(jm.moe_layers):
            if m is not None:
                for n in ("w_router", "w1", "w2"):
                    arrays[f"{name}_m{i}_{n}"] = np.asarray(getattr(m, n))
                arrays[f"{name}_m{i}_cf"] = np.asarray(m.capacity_factor)
                arrays[f"{name}_m{i}_gs"] = np.asarray(m.group_size)
    np.savez(out / "lm_serve_in.npz", **arrays)
    _spawn("serve", out, _free_port())
    return out, dict(np.load(out / "rank0.npz"))


def _jax_ppl(jm):
    """The JAX package's perplexity of ``jm`` on the held-out stream, dense
    CE and chunked."""
    from keystone_tpu.evaluation.perplexity import evaluate_perplexity as j_eval

    return [j_eval(jm, _held_out(), seq=EVAL_SEQ, batch=EVAL_BATCH, logit_chunk=c)["loss"]
            for c in (0, EVAL_CHUNK)]


@pytest.fixture(scope="module")
def lm_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mh_lm")
    _write_lm_in(out, _jax_lm()[0])
    _spawn("lm", out, _free_port())
    return dict(np.load(out / "rank0.npz"))


# -- pure functions and errors, in this process


def _dumps(kind: str) -> list:
    if kind == "counters":
        return [{"rows": {"kind": "counter", "value": 100}, "only0": {"kind": "counter",
                                                                      "value": 3}},
                {"rows": {"kind": "counter", "value": 200}, "calls{host=1}": {
                    "kind": "counter", "value": 2}}]
    if kind == "gauges":
        return [{"peak": {"kind": "gauge", "value": 1000.0}},
                {"peak": {"kind": "gauge", "value": 2500.0}, "other": {"kind": "gauge",
                                                                       "value": -1.0}},
                {"peak": {"kind": "gauge", "value": 2000.0}}]
    rng = np.random.default_rng(11)
    dumps = []
    for h in range(3):
        s = [float(v) for v in rng.uniform(0.01 * (h + 1), 0.02 * (h + 1), size=7 + h)]
        dumps.append({"step_s": {"kind": "timer", "count": len(s), "total_s": sum(s),
                                 "min_s": min(s), "max_s": max(s), "p50_s": s[0],
                                 "samples": s}})
    dumps.append({"step_s": {"kind": "timer", "count": 0, "total_s": 0.0, "max_s": 0.0,
                             "samples": []}})
    return dumps


@pytest.mark.parametrize("kind", ["counters", "gauges", "timers"])
def test_merge_metric_dumps_matches_jax(kind):
    got = multihost.merge_metric_dumps(_dumps(kind))
    want = jmultihost.merge_metric_dumps(_dumps(kind))
    assert got == want


def test_initialize_errors_match_jax(free_tcp_port, monkeypatch):
    """A dead coordinator raises within the timeout and names the address;
    a partial KEYSTONE_* group raises, naming the missing variable."""
    addr = f"127.0.0.1:{free_tcp_port}"
    for init in (multihost.initialize, jmultihost.initialize):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="unreachable") as err:
            init(addr, 2, 1, init_timeout_s=0.5)
        assert addr in str(err.value) and time.monotonic() - t0 < 10
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("KEYSTONE_COORDINATOR", addr)
    monkeypatch.setenv("KEYSTONE_NUM_PROCESSES", "2")
    for init in (multihost.initialize, jmultihost.initialize):
        with pytest.raises(RuntimeError, match="KEYSTONE_PROCESS_ID.*must be set as a group"):
            init()
    assert not multihost.is_initialized()


def test_one_process_group_and_shards(monkeypatch):
    """``initialize`` alone forms a group of one over gloo; ``_shards``
    counts the cards that hold rows, so a one-process mesh counts 1 where
    the reference counts its data axis."""
    from keystone_tpu import plan as jplan
    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu_torch import plan as plan_mod

    one_process = create_mesh(data=4, devices=["cpu"] * 4)
    assert plan_mod._shards(plan_mod.Plan(prefix=[], mesh=one_process)) == 1
    j_mesh = jmesh.create_mesh(data=4)
    assert jplan._shards(jplan.Plan(prefix=[], mesh=j_mesh)) == 4
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    try:
        assert multihost.initialize(device="cpu") == torch.device("cpu")
        assert multihost.process_count() == 1 and multihost.is_initialized()
        assert multihost.group_devices() == (torch.device("cpu"),)
        x = torch.arange(3.0)
        assert torch.equal(multihost.all_reduce_(x), torch.arange(3.0))
    finally:
        multihost.shutdown()
        for key in _ENV_KEYS:
            os.environ.pop(key, None)


# -- two processes against the JAX package


def test_two_process_fit_matches_single_process(fit_run):
    _, got = fit_run
    data, labels = _fit_data()
    est = jlinear.BlockLeastSquaresEstimator(block_size=7, num_iter=3, lam=0.1)
    ref = est.fit(jnp.asarray(data), jnp.asarray(labels))
    want = np.concatenate([np.asarray(x) for x in ref.xs])
    np.testing.assert_allclose(got["fit_x"], want, atol=2e-4)
    np.testing.assert_allclose(got["fit_b"], np.asarray(ref.b), atol=2e-4)
    assert bool(got["fit_replicas_equal"])


def test_allmerge_fit_state_matches_jax_merge(fit_run):
    _, got = fit_run
    states = []
    for rank in range(2):
        a, b = _merge_chunk(rank)
        states.append(jlinear.normal_eq_update(jlinear.normal_eq_init(16, 3), jnp.asarray(a),
                                               jnp.asarray(b)))
    want = j_fit_stats_merge(states[0], states[1])
    for name in ("ata", "atb", "mean_a", "mean_b", "n"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(got[f"merge_{name}"], w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()), err_msg=name)


def test_assemble_global_unequal_and_empty_ranks(fit_run):
    _, got = fit_run
    for i, tag in enumerate(("empty", "unequal")):
        parts = [_assemble_inputs(r)[i] for r in range(2)]
        width = max(f.shape[-1] for f, _ in parts)
        want_f = np.concatenate([f.reshape(-1, width) if f.size else np.zeros((0, width),
                                                                              np.float32)
                                 for f, _ in parts])
        want_y = np.concatenate([y for _, y in parts])
        np.testing.assert_array_equal(got[f"assemble_{tag}_f"], want_f)
        np.testing.assert_array_equal(got[f"assemble_{tag}_y"], want_y)


def test_metrics_rollup_two_processes(fit_run):
    out, got = fit_run
    assert bool(got["rollup_on_rank"])
    merged = json.loads((out / "metrics_cluster.json").read_text())
    assert merged["hosts"] == 2
    m = merged["metrics"]
    assert m["mh_rows"] == 300
    assert m["mh_calls{host=0}"] == 1 and m["mh_calls{host=1}"] == 2
    assert m["mh_hbm_peak"] == 2000.0
    assert m["mh_step_seconds"]["count"] == 20 and "p95_s" in m["mh_step_seconds"]


def test_mesh_across_processes_shards_rows(fit_run):
    """Over a mesh across two processes, ``shard_batch`` gives each its
    row block of the padded batch (rank 0: rows 0-2 of 5 padded to 6) and
    ``gather`` puts the valid rows back together; on a one-process mesh
    the placement helpers name its first device."""
    from keystone_tpu_torch.parallel import data_sharding_fn, replicated_sharding

    _, got = fit_run
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal(got["shard_local"], x[:3])
    np.testing.assert_array_equal(got["shard_layout"], [5, 0, 3])
    np.testing.assert_array_equal(got["shard_gather"], x)
    mesh = create_mesh(data=2, devices=["cpu", "meta"])
    assert replicated_sharding(mesh) == torch.device("cpu")
    place = data_sharding_fn(mesh)
    assert place((torch.ones(2), torch.ones(2, 3))) == (torch.device("cpu"),) * 2
    assert data_sharding_fn(None) is None


def test_two_process_mnist_matches_one_process(fit_run):
    """MNIST random-FFT across two processes (the classic fit and the
    streamed int8 fit over the planner's row blocks) against one process of
    the port: the same test predictions, errors global on every process,
    and the streamed fit's weights."""
    from keystone_tpu_torch.models import mnist_random_fft
    from keystone_tpu_torch.plan import fused_fit

    _, got = fit_run
    assert int(got["mesh_data"]) == 2 and int(got["plan_shards"]) == 2
    for tag, env in (("classic", {}), ("streamed", {"KEYSTONE_PLAN": "1",
                                                    "KEYSTONE_GRAM_OP": "int8"})):
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            mp.setattr(fused_fit, "_DEFAULT_FIT_CHUNK", MNIST_FIT_CHUNK)
            with _finalized() as weights:
                want = mnist_random_fft.main(MNIST_ARGV, device="cpu")
        assert int(got[f"mnist_{tag}_procs"]) == 2
        agree = float(np.mean(got[f"mnist_{tag}_pred"] == want["test_predictions"]))
        assert agree >= 0.995, (tag, agree)
        np.testing.assert_allclose(got[f"mnist_{tag}_err"],
                                   [want["train_error"], want["test_error"]], atol=0.01)
        if weights:
            # the streamed fits fold the same chunks: the merged statistics
            # give the same solve, held at the f32 solve paths' 1e-3 of
            # max|W| (tests/test_torch_mnist.py)
            w = weights[-1]
            assert np.abs(got[f"mnist_{tag}_w"] - w).max() <= 1e-3 * np.abs(w).max(), tag


def test_two_process_lm_training_matches_single_process(lm_run):
    """Data-parallel steps across two processes against the JAX one-process
    run on the same batches (the reference test's bars)."""
    model, losses = _jax_steps(LM_STEPS)
    np.testing.assert_allclose(lm_run["losses"], losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lm_run["wq"], np.asarray(model.blocks[0].wq), atol=5e-5)
    np.testing.assert_allclose(lm_run["embed"], np.asarray(model.embed), atol=5e-5)


def test_two_process_train_matches_jax_train(lm_run):
    """``train`` across two processes against the JAX package's ``train``
    in one process, from the same weights."""
    from keystone_tpu.models.lm.train import train as j_train

    jm, _, _, corpus = _jax_lm()
    jm, j_losses = j_train(jm, corpus, steps=LM_STEPS, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR,
                           seed=TRAIN_SEED)
    np.testing.assert_allclose(lm_run["train_losses"], j_losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lm_run["train_wq"], np.asarray(jm.blocks[0].wq), atol=5e-5)
    np.testing.assert_allclose(lm_run["train_embed"], np.asarray(jm.embed), atol=5e-5)


def test_two_process_checkpoint_resume(tmp_path):
    """Coordinated checkpoints across two processes: two steps, a crash,
    then a rerun that restores on every process and finishes four steps,
    against the JAX package's uninterrupted four."""
    _write_lm_in(tmp_path, _jax_lm()[0])
    ckdir = tmp_path / "mh_ck"
    _spawn("ckpt", tmp_path, _free_port(), ckdir, "crash")
    assert not (tmp_path / "rank0.npz").exists()
    assert sorted(p.name for p in ckdir.glob("step_*")) == ["step_1", "step_2"]
    _spawn("ckpt", tmp_path, _free_port(), ckdir, "resume")
    got = np.load(tmp_path / "rank0.npz")
    model, _ = _jax_steps(4)
    np.testing.assert_allclose(got["wq"], np.asarray(model.blocks[0].wq), atol=5e-5)
    np.testing.assert_allclose(got["embed"], np.asarray(model.embed), atol=5e-5)


def test_multihost_flag_runs_a_pipeline_under_supervise(tmp_path):
    """``supervise --procs 2 -- python -m keystone_tpu_torch --multihost
    --observe DIR mnist-random-fft ...`` joins the two processes from the
    supervisor's environment, runs the pipeline on each one's rows and
    rolls their metrics up into process 0's run directory."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("KEYSTONE_")}
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"
    obs = tmp_path / "obs"
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "supervise", "--procs", "2",
           "--max-restarts", "0", "--", sys.executable, "-m", "keystone_tpu_torch",
           "--multihost", "--observe", str(obs), "mnist-random-fft", *MNIST_ARGV,
           "--device", "cpu"]
    # a session of its own: on a timeout the supervisor and its children go
    sup = subprocess.Popen(cmd, env=env, cwd=root, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = sup.communicate(timeout=PAIR_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(sup.pid, 9)
        sup.wait()
        pytest.fail(f"supervise --multihost outlived {PAIR_LIMIT_S:.0f} s")
    assert sup.returncode == 0, err[-3000:]
    assert err.count("MnistRandomFFT: train err") == 2, err[-3000:]
    (merged,) = [json.loads(p.read_text()) for p in obs.glob("*/metrics_cluster.json")]
    assert merged["hosts"] == 2
    assert merged["metrics"]["cluster_events{action=monitor_start}"] == 2


# -- tensor, pipeline and sequence parallelism across processes


def test_four_process_tp_and_pp_across_processes(tp_run):
    """dp × tp on (2, 2) and TP on (1, 4) across four processes against the
    JAX package's one-process training on the same batches, and the dp × pp
    forward against the plain block chain (``tests/test_multihost.py:182``).
    Rank r sits at (r // model, r % model); every replica ends equal. (The
    fits' row blocks over such a mesh are
    ``test_four_process_rows_over_data_and_model``'s.)"""
    from _lm_worker_common import SEQ, build_tp, step_batch

    model, optimizer, step, corpus = build_tp()
    opt_state = optimizer.init(model)
    losses = []
    for i in range(LM_STEPS):
        model, opt_state, loss = step(model, opt_state, jnp.asarray(step_batch(corpus, i)))
        losses.append(float(loss))
    for tag in ("dptp", "tp4"):
        np.testing.assert_array_equal(tp_run[f"{tag}_coords"], [0, 0])
        np.testing.assert_allclose(tp_run[f"{tag}_losses"], losses, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tp_run[f"{tag}_wq"], np.asarray(model.blocks[0].wq), atol=5e-5)
        np.testing.assert_allclose(tp_run[f"{tag}_embed"], np.asarray(model.embed), atol=5e-5)
        assert bool(tp_run[f"{tag}_equal"]) and bool(tp_run[f"{tag}_roundtrip"]), tag
    model2, _, _, _ = build_tp()
    toks_pp = step_batch(corpus, 99)[:, :SEQ].astype(np.int32)
    np.testing.assert_allclose(tp_run["pp"], np.asarray(model2(jnp.asarray(toks_pp))), atol=2e-4)


def test_four_process_pp_train_step_matches_local(tp_run):
    """One dp × pp train step across four processes (two stages, two data
    rows, the reverse schedule over gloo) against the JAX package's local
    step (``tests/test_lm_transformer.py:449``'s bars)."""
    import jax

    from _lm_worker_common import build_tp, step_batch

    model, optimizer, step, corpus = build_tp()
    model, _, loss = step(model, optimizer.init(model), jnp.asarray(step_batch(corpus, 0)))
    np.testing.assert_allclose(tp_run["pp_step_loss"], [float(loss)], atol=1e-5)
    want = np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree_util.tree_leaves(model)])
    np.testing.assert_allclose(tp_run["pp_step_leaves"], want, atol=5e-4)
    assert bool(tp_run["pp_step_equal"])


def test_four_process_pp_tp_train_step_matches_local(tp_run):
    """pp × tp across four processes: two pipeline stages, each stage's
    blocks split over a model axis of two (a (pipe 2, data 1, model 2)
    mesh, rank r at (r // 2, 0, r % 2)), one train step against the JAX
    package's plain local step (``tests/test_lm_transformer.py:546``'s
    bars: loss 1e-5, leaves 5e-4) and against the port's one-process step
    on the same 3-axis mesh of CPU positions (loss 1e-5 relative); every
    replica ends equal."""
    import jax

    from _lm_worker_common import build_tp, step_batch
    from keystone_tpu_torch.models.lm import make_optimizer, make_pp_train_step, shard_params
    from keystone_tpu_torch.parallel import Mesh

    np.testing.assert_array_equal(tp_run["pptp_coords"],
                                  [[0, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 1]])
    model, optimizer, step, corpus = build_tp()
    batch = step_batch(corpus, 0)
    model, _, loss = step(model, optimizer.init(model), jnp.asarray(batch))
    np.testing.assert_allclose(tp_run["pptp_step_loss"], [float(loss)], atol=1e-5)
    want = np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree_util.tree_leaves(model)])
    np.testing.assert_allclose(tp_run["pptp_step_leaves"], want, atol=5e-4)
    assert bool(tp_run["pptp_equal"])

    from keystone_tpu_torch import convert

    jm = build_tp()[0]
    leaves = {"embed": np.asarray(jm.embed), "pos_embed": np.asarray(jm.pos_embed),
              "blocks": [{n: np.asarray(getattr(b, n)) for n in SERVE_WEIGHTS}
                         for b in jm.blocks]}
    one = convert.transformer_lm(leaves, num_heads=jm.num_heads, device="cpu")
    mesh = Mesh([[["cpu"] * 2]] * 2, ("pipe", "data", "model"))
    opt = make_optimizer(LM_LR, weight_decay=1e-4)
    one = shard_params(one, mesh)
    _, _, one_loss = make_pp_train_step(opt, mesh, n_micro=2, axis="pipe", data_axis="data")(
        one, opt.init(one.leaves()), torch.from_numpy(np.asarray(batch)))
    np.testing.assert_allclose(tp_run["pptp_step_loss"], [float(one_loss)], rtol=1e-5)


def test_four_process_rows_over_data_and_model(tp_run):
    """Row blocks over a (data 2, model 2) mesh across four processes lie
    as the reference's ``shard_batch`` lays them: rank r at (r // 2, r % 2)
    holds the block of its data position, the same rows on both model
    positions of a data row (the replicas of ``P("data")``); ``gather``
    and ``global_batch_from_local`` count each row once."""
    import jax
    from jax.sharding import PartitionSpec as P

    from keystone_tpu.parallel import mesh as jmesh

    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    jm = jcreate_mesh(data=2, model=2, devices=jax.devices()[:4])
    placed = jmesh.shard_batch(x, jm)
    assert placed.sharding.spec == P("data", None)
    padded = np.asarray(placed)
    by_device = {s.device: s.index[0] for s in placed.addressable_shards}
    layout = tp_run["dm_layout"]
    for r, (i, j, lo, n_local, n_valid, n_global, a_lo, a_n) in enumerate(layout):
        want = by_device[jm.devices[i, j]]
        assert (lo, lo + n_local) == (want.start, want.stop), (r, want)
        np.testing.assert_array_equal(tp_run["dm_local"][r], padded[want])
        assert (n_valid, n_global) == (min(n_local, 5 - lo), 5)
        assert (a_lo, a_n) == ((0, 5) if i == 0 else (2, 5))
    np.testing.assert_array_equal(layout[:, :2], [[0, 0], [0, 1], [1, 0], [1, 1]])
    np.testing.assert_array_equal(tp_run["dm_gather"], x)
    np.testing.assert_array_equal(tp_run["dm_assembled"], x)


def test_four_process_mnist_over_data_and_model(tp_run, fit_run):
    """MNIST's classic fit and its streamed int8 fit over a (data 2, model
    2) mesh across four processes: each within 2e-4 (and 1e-3 of max|W|,
    ``tests/test_torch_mnist.py``'s bar) of the JAX package's one-process
    fit of the same features, and of the (data 2) fit across two
    processes; the evaluator's train and test errors equal the (data 2)
    fit's, and every rank holds the same weights."""
    from keystone_tpu import plan as jplan
    from keystone_tpu.core.pipeline import ChainedLabelEstimator as JChained
    from keystone_tpu.core.pipeline import Identity as JIdentity
    from keystone_tpu.ops.util import ClassLabelIndicators as JCLI
    from keystone_tpu_torch.models import mnist_random_fft as tm

    _, two = fit_run
    conf = tm.parse_config(tm.MnistRandomFFTConfig, MNIST_ARGV)
    train = tm._load(conf, "train")
    bank = tm.build_batch_featurizers(conf.num_ffts, conf.block_size, conf.seed,
                                      image_size=train.data.shape[-1], device="cpu")
    feats = jnp.asarray(torch.cat(tm.featurize(bank, torch.from_numpy(train.data)), -1).numpy())
    labels = JCLI(num_classes=10)(train.labels)
    est = jlinear.BlockLeastSquaresEstimator(block_size=conf.block_size, num_iter=1,
                                             lam=conf.lam)
    streamed = jplan.fit_streaming(JChained(prefix=JIdentity(), est=est), feats, labels,
                                   n_valid=len(train), gram="int8", chunk_size=MNIST_FIT_CHUNK)
    want = {"classic": est.fit(feats, labels), "streamed": streamed[-1]}
    for tag, jmodel in want.items():
        w = np.concatenate([np.asarray(x) for x in jmodel.xs])
        got = tp_run[f"dm_mnist_{tag}_w"]
        for ref in (w, two[f"mnist_{tag}_w"]):
            gap = np.abs(got - ref).max()
            assert gap <= 2e-4 and gap <= 1e-3 * np.abs(ref).max(), (tag, gap)
        np.testing.assert_array_equal(tp_run[f"dm_mnist_{tag}_err"], two[f"mnist_{tag}_err"])
        agree = float(np.mean(tp_run[f"dm_mnist_{tag}_pred"] == two[f"mnist_{tag}_pred"]))
        assert agree >= 0.995, (tag, agree)
        assert bool(tp_run[f"dm_mnist_{tag}_equal"]), tag


def test_two_process_weighted_fit_over_global_rows(fit_run):
    """The class-weighted solver over a global batch whose rows are split
    over two processes (one class holding 85 % of them), against the JAX
    package's one-process fit and the port's (``tests/test_torch_weighted.py``'s
    bar: 1e-4 of max|W|, intercepts 1e-4 of max(max|W|, max|b|)); both
    processes hold the same model."""
    from keystone_tpu.ops import weighted_linear as jw
    from keystone_tpu_torch.ops import weighted_linear as tw

    _, got = fit_run
    a, y = _weighted_data()
    jmodel = jw.BlockWeightedLeastSquaresEstimator(**WEIGHTED_EST).fit(jnp.asarray(a),
                                                                       jnp.asarray(y))
    est = tw.BlockWeightedLeastSquaresEstimator(**WEIGHTED_EST)
    tmodel = est.fit(torch.from_numpy(a), torch.from_numpy(y))
    for xs, b in ((jmodel.xs, jmodel.b), (tmodel.xs, tmodel.b)):
        w = np.concatenate([np.asarray(x) for x in xs])
        scale = np.abs(w).max()
        assert np.abs(got["weighted_x"] - w).max() <= 1e-4 * scale
        assert np.abs(got["weighted_b"] - np.asarray(b)).max() <= 1e-4 * max(
            scale, np.abs(np.asarray(b)).max())
    assert bool(got["weighted_equal"])
    # the one-process fit takes the masked layout too: one fixed point
    assert tw.fit_path(est, torch.from_numpy(y), WEIGHTED["d"])["layout"] == "masked"


def test_two_process_streamed_fallback_fits_row_blocks(fit_run):
    """``fit_streaming`` forced onto its materialized fallback (a memory
    budget below the state) under a mesh across two processes: each
    process featurizes its own 128 of the 256 rows, and the model equals
    the fused two-process fit's within 2e-4
    (``test_two_process_fit_matches_single_process``'s bar)."""
    _, got = fit_run
    assert bool(got["fallback_fused"]) and str(got["fallback_reason"]) == "state_over_budget"
    np.testing.assert_array_equal(got["fallback_rows"], [[FIT_N // 2] * 2] * 2)
    np.testing.assert_allclose(got["fallback_w"], got["fused_w"], atol=2e-4)


def test_fallback_without_a_global_rows_branch_raises():
    """An estimator without a ``GlobalRows`` fit refuses a global batch,
    naming itself, rather than fit one process's block as the batch."""
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Identity, LabelEstimator
    from keystone_tpu_torch.parallel import GlobalRows

    class OwnRowsOnly(LabelEstimator):
        def fit(self, data, labels, **kw):
            raise AssertionError("fitted a global batch's block as the batch")

    rows = GlobalRows(torch.zeros((4, 3)), 8, 0)
    with pytest.raises(TypeError, match="OwnRowsOnly has no GlobalRows fit"):
        ChainedLabelEstimator(prefix=Identity(), est=OwnRowsOnly()).fit(rows, torch.zeros((4, 2)))


def test_four_process_tp_perplexity_matches_jax(tp_run):
    """``evaluate_perplexity`` of a model sharded over four processes
    (vocab-sharded CE, dense and chunked) against the JAX package's."""
    from _lm_worker_common import build_tp

    np.testing.assert_allclose(tp_run["tp4_ppl"], _jax_ppl(build_tp()[0]), rtol=1e-5)


def test_two_process_ring_and_ulysses_match_dense(sp_run):
    """Ring hops and Ulysses all_to_alls across two processes, causal and
    not, against dense attention (``tests/test_multihost.py:102``)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=ATTN_SHAPE).astype(np.float32) for _ in range(3))

    def dense(causal):
        s = q.shape[2]
        logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
        if causal:
            logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
        w = np.exp(logits - logits.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        return np.einsum("bhqk,bhkd->bhqd", w, v)

    for causal in (False, True):
        want = dense(causal)
        for name in ("ring", "ulysses"):
            np.testing.assert_allclose(sp_run[f"{name}_causal{causal}"], want, atol=2e-4,
                                       err_msg=f"{name} causal={causal}")


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_two_process_sequence_parallel_train_matches_jax(sp_run, mode):
    """Three train steps of a ring or Ulysses model across two processes,
    every rank on the whole batch, against the JAX package's local steps
    (``tests/test_multihost.py:182``'s bars); the replicas stay equal with
    no gradient all-reduce."""
    model, losses = _jax_steps(LM_STEPS)
    np.testing.assert_allclose(sp_run[f"{mode}_losses"], losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sp_run[f"{mode}_wq"], np.asarray(model.blocks[0].wq), atol=5e-5)
    np.testing.assert_allclose(sp_run[f"{mode}_embed"], np.asarray(model.embed), atol=5e-5)
    assert bool(sp_run[f"{mode}_equal"])


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_two_process_sequence_parallel_perplexity(sp_run, mode):
    """``evaluate_perplexity`` of a ring or Ulysses model across two
    processes against the JAX package's local model."""
    np.testing.assert_allclose(sp_run[f"{mode}_ppl"], _jax_ppl(_jax_lm()[0]), rtol=1e-5)


def test_two_process_tp_checkpoint_resume(sp_run):
    """A TP model over two processes trains two checkpointed steps and
    stops; a second run restores the whole leaves into fresh shards and
    finishes four, against the JAX package's uninterrupted ``train``. The
    last checkpoint holds the whole leaves, bit for bit."""
    from keystone_tpu.models.lm.train import train as j_train

    jm, _, _, corpus = _jax_lm()
    jm, j_losses = j_train(jm, corpus, steps=4, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR,
                           seed=TRAIN_SEED)
    np.testing.assert_allclose(sp_run["ckpt_losses"], j_losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sp_run["ckpt_wq"], np.asarray(jm.blocks[0].wq), atol=5e-5)
    np.testing.assert_allclose(sp_run["ckpt_embed"], np.asarray(jm.embed), atol=5e-5)
    assert int(sp_run["ckpt_step"]) == 4
    assert bool(sp_run["ckpt_whole_bits"]) and bool(sp_run["ckpt_equal"])


# -- serving a sharded model across processes


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_two_process_tp_serving_matches_jax(serve_run, name):
    """A model sharded over two processes serves the JAX package's sharded
    tokens: greedy ``generate`` (an f32 and an int8 KV cache) and the slot
    pool of ``export_lm(quantize=True)``, equal on both ranks. Each rank's
    cache holds its two of the four KV heads; over gloo the loop is not
    graphed. The MoE model's routing gaps exceed 1e-4 on the same
    inputs."""
    import jax

    from keystone_tpu.models import lm_transformer as jlm
    from keystone_tpu.serve.export import export_lm as j_export_lm

    out, run = serve_run
    jm = jlm.shard_params(_jax_serve_models()[name],
                          jcreate_mesh(data=4, model=2, devices=jax.devices()))
    prompt, loop_prompts = _serve_prompts()
    want = np.asarray(jlm.generate(jm, jnp.asarray(prompt), max_new=SERVE_NEW))
    want8 = np.asarray(jlm.generate(jm, jnp.asarray(prompt), max_new=SERVE_NEW, kv_dtype="int8"))
    want_loop = j_export_lm(jm, quantize=True, **SERVE_LOOP).run(loop_prompts)
    np.testing.assert_array_equal(run[f"{name}_generate"], want)
    np.testing.assert_array_equal(run[f"{name}_generate_kv8"], want8)
    np.testing.assert_array_equal(run[f"{name}_loop"], np.concatenate(want_loop))
    assert bool(run[f"{name}_equal"]) and not bool(run[f"{name}_graphed"])
    assert int(run[f"{name}_cache_heads"]) == int(run[f"{name}_local_heads"]) == 2
    if name == "moe":
        pm = _serve_model(out, "moe")
        margins = []
        handles = [m.register_forward_hook(lambda mod, args, o: margins.append(float(
            torch.diff(torch.sort(args[0].reshape(-1, args[0].shape[-1]).double()
                                  @ mod.w_router.double(), dim=-1).values[:, -3:],
                       dim=-1).min()))) for m in pm.experts]
        try:
            from keystone_tpu_torch.models.lm import generate

            generate(pm, torch.from_numpy(prompt), max_new=SERVE_NEW)
        finally:
            for h in handles:
                h.remove()
        assert margins and min(margins) > 1e-4


def test_two_process_quantize_of_shards_matches_jax(serve_run):
    """``quantize_for_decode`` of the shards across two processes, gathered,
    equals the port's whole quantization and the JAX package's
    quantization of its sharded model, codes and scales bit for bit."""
    import jax

    from keystone_tpu.models import lm_transformer as jlm

    _, run = serve_run
    jq = jlm.quantize_for_decode(jlm.shard_params(
        _jax_serve_models()["dense"], jcreate_mesh(data=4, model=2, devices=jax.devices())))
    leaves = [jq.embed] + [getattr(b, n) for b in jq.blocks for n in SERVE_WEIGHTS]
    np.testing.assert_array_equal(
        run["q_codes"], np.concatenate([np.asarray(w.q).reshape(-1) for w in leaves]))
    np.testing.assert_array_equal(
        run["q_scales"], np.concatenate([np.asarray(w.scale).reshape(-1) for w in leaves]))
    assert bool(run["q_whole_bits"])
