"""keystone_tpu_torch's LM training against the JAX package's: every leaf's
gradient of ``next_token_loss`` against ``jax.grad`` (learned and rope
positions, GQA, dense and chunked CE, remat none / full / dots, local,
ring and Ulysses attention), ``make_optimizer`` against optax step for
step, ``train`` and ``lm_transformer.main`` against the JAX ones, and the
pieces copied as they are. The JAX tiny models are carried across with
``convert.transformer_lm``; tokens, gradients and corpora come from numpy
seeds; everything is f32. The sequence-parallel models run on 4 of the
JAX package's 8 virtual devices and on a 4-position CPU mesh."""

import dataclasses

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from keystone_tpu.models import lm_transformer as jlm  # noqa: E402
from keystone_tpu.models.lm.model import train_step_flops as j_flops  # noqa: E402
from keystone_tpu.models.lm.train import _step_batch as j_step_batch  # noqa: E402
from keystone_tpu.models.lm.train import make_optimizer as j_make_optimizer  # noqa: E402
from keystone_tpu.models.lm.train import train as j_train  # noqa: E402
from keystone_tpu.parallel import mesh as jmesh  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.models import lm, lm_transformer  # noqa: E402
from keystone_tpu_torch.models.lm import model as lm_model  # noqa: E402
from keystone_tpu_torch.models.lm.train import (  # noqa: E402
    _step_batch,
    make_optimizer,
    make_train_step,
    train,
)
from keystone_tpu_torch.parallel import create_mesh  # noqa: E402

# tests/test_lm_transformer.py:147 holds the JAX package's remat grads at
# these: the same f32 arithmetic summed in another order
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
# optax against the port on the same gradients: one f32 rounding apart
# per operation
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
VOCAB, SEQ = 31, 16
N = 4  # sequence-parallel positions


def leaves(jm) -> dict:
    return {
        "embed": jm.embed,
        "pos_embed": jm.pos_embed,
        "blocks": [
            {n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
            for b in jm.blocks
        ],
    }


def j_leaves(jm) -> list:
    return jax.tree_util.tree_leaves(jm)


def port_of(jm, **kw) -> lm.TransformerLM:
    return convert.transformer_lm(
        leaves(jm), num_heads=jm.num_heads, num_kv_heads=jm.num_kv_heads,
        pos_encoding=jm.pos_encoding, compute_dtype=jm.compute_dtype, remat=jm.remat,
        remat_policy=jm.remat_policy, device="cpu", **kw,
    )


def _tiny(pos_encoding="learned", num_kv_heads=0, depth=2, **kw):
    return jlm.TransformerLM.create(
        jax.random.key(0), vocab=VOCAB, max_seq=2 * SEQ, dim=32, depth=depth, num_heads=4,
        pos_encoding=pos_encoding, num_kv_heads=num_kv_heads, **kw,
    )


def _tokens(seed, batch=2):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(batch, SEQ + 1))


def _port_grads(pm, toks, logit_chunk):
    params = pm.leaves()
    for p in params:
        p.requires_grad_(True)
    loss = lm.next_token_loss(pm, torch.from_numpy(toks), logit_chunk=logit_chunk)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), [np.zeros(p.shape, np.float32) if g is None else g.numpy()
                         for g, p in zip(grads, params)]


@pytest.fixture(scope="module")
def jax_mesh(devices):
    return jmesh.create_mesh(data=N)


CASES = {
    # name: (JAX model kwargs, logit_chunk)
    "learned": (dict(), 0),
    "learned_chunked": (dict(), 8),
    "rope_gqa_chunked": (dict(pos_encoding="rope", num_kv_heads=2), 4),
    "remat_full": (dict(remat=True, remat_policy="full"), 0),
    "remat_dots": (dict(remat=True, remat_policy="dots"), 0),
    "remat_full_rope_chunked": (dict(pos_encoding="rope", remat=True), 8),
    "remat_dots_gqa": (dict(num_kv_heads=2, remat=True, remat_policy="dots"), 0),
    # one block: the JAX ring compiles for tens of seconds a block
    "ring_rope_gqa_chunked": (dict(pos_encoding="rope", num_kv_heads=2, seq_mode="ring",
                                   depth=1), 8),
    "ulysses_rope": (dict(pos_encoding="rope", seq_mode="ulysses", depth=1), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_leaf_gradients_match_jax(jax_mesh, case):
    """Every leaf's gradient of next_token_loss, and the loss, against
    jax.grad on the same leaves and tokens."""
    kw, chunk = CASES[case]
    remat = {k: kw.pop(k) for k in ("remat", "remat_policy") if k in kw}
    seq_mode = kw.pop("seq_mode", "local")
    jm = _tiny(**kw)
    if seq_mode != "local":
        jm = dataclasses.replace(jm, seq_mode=seq_mode, mesh=jax_mesh)
    jm = dataclasses.replace(jm, **remat)
    toks = _tokens(1)
    j_loss, j_grads = jax.value_and_grad(
        lambda m: jlm.next_token_loss(m, jnp.asarray(toks), logit_chunk=chunk))(jm)
    mesh = create_mesh(data=N, devices=["cpu"] * N) if seq_mode != "local" else None
    pm = port_of(jm, seq_mode=seq_mode, mesh=mesh)
    loss, grads = _port_grads(pm, toks, chunk)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    j_grads = j_leaves(j_grads)
    assert len(grads) == len(j_grads) == 2 + 6 * len(jm.blocks)
    for i, (g, jg) in enumerate(zip(grads, j_grads)):
        np.testing.assert_allclose(g, np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"leaf {i}")


def test_flash_local_attention_gradients_match_jax(monkeypatch):
    """``KST_LOCAL_ATTN=flash``: K2's plain version forward and the flash
    backward in the port, dense attention in the JAX package (its CPU
    default): the same gradients."""
    jm = _tiny()
    toks = _tokens(2)
    j_grads = j_leaves(jax.grad(lambda m: jlm.next_token_loss(m, jnp.asarray(toks)))(jm))
    for env in ({}, {"KST_FLASH_DENSE_BWD_MAX": "0", "KST_FLASH_BWD_BLOCK": "8"}):
        monkeypatch.setenv("KST_LOCAL_ATTN", "flash")
        for name, val in env.items():
            monkeypatch.setenv(name, val)
        _, grads = _port_grads(port_of(jm), toks, 0)
        for g, jg in zip(grads, j_grads):
            np.testing.assert_allclose(g, np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


class _CountProducts(TorchDispatchMode):
    """Counts the weight products (``aten.mm``/``aten.addmm``) run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_rerun_the_products_they_should():
    """"dots" saves every weight product: forward and backward run as
    many as without remat. "full" recomputes each block in the backward
    up to the last product the backward reads — wq, wk, wv, wo and w1, 5
    per block (w2's output feeds only the residual sum, so the recompute
    stops before it, as XLA's dead-code elimination drops it from the JAX
    package's rematerialized block)."""
    jm = _tiny()
    toks = _tokens(3)
    counts, grads = {}, {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        pm = port_of(dataclasses.replace(jm, remat=remat, remat_policy=policy))
        with _CountProducts() as c:
            _, grads[remat, policy] = _port_grads(pm, toks, 0)
        counts[remat, policy] = c.n
    depth = len(jm.blocks)
    assert counts[True, "dots"] == counts[False, "full"]
    assert counts[True, "full"] == counts[False, "full"] + 5 * depth
    for key in ((True, "full"), (True, "dots")):
        for a, b in zip(grads[key], grads[False, "full"]):
            np.testing.assert_array_equal(a, b)


def test_remat_policy_and_int8_leaves_rejected():
    jm = _tiny()
    with pytest.raises(ValueError, match="remat_policy"):
        port_of(dataclasses.replace(jm, remat=True, remat_policy="nope"))(
            torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="remat_policy"):
        lm_model.remat_wrap(lambda x: x, "nope")
    qm = lm.quantize_for_decode(port_of(jm))
    assert lm_model.has_quantized_leaves(qm)
    with pytest.raises(ValueError, match="int8"):
        train(qm, lm.synthetic_corpus(500, VOCAB), steps=1, batch=2, seq=SEQ)


# --- the optimizer against optax -------------------------------------------

OPT_CASES = {
    "constant": dict(lr=1e-2),
    "cosine": dict(lr=1e-2, steps=6, schedule="cosine", warmup_frac=0.34),
    "cosine_clip": dict(lr=1e-2, steps=6, schedule="cosine", grad_clip=0.5),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax_step_for_step(case):
    """Six updates of three leaves from the same gradients: the
    parameters after every step. The cosine cases' first update uses
    lr(0) = 0 and moves nothing; the clip case clips every step."""
    kw = OPT_CASES[case]
    shapes = [(5, 3), (7,), (2, 4, 3)]
    rng = np.random.default_rng(4)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * (1 + step)).astype(np.float32) for s in shapes]
             for step in range(6)]
    j_opt = j_make_optimizer(**kw)
    j_params = [jnp.asarray(p) for p in params]
    j_state = j_opt.init(j_params)
    opt = make_optimizer(**kw)
    p_params = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(p_params)
    for step, g in enumerate(grads):
        if "grad_clip" in kw:
            assert np.sqrt(sum(float((x * x).sum()) for x in g)) > kw["grad_clip"]
        updates, j_state = j_opt.update([jnp.asarray(x) for x in g], j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update([torch.from_numpy(x) for x in g], state, p_params)
        for p, jp in zip(p_params, j_params):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=f"step {step}")
        if step == 0 and kw.get("schedule") == "cosine":
            for p, p0 in zip(p_params, params):
                np.testing.assert_array_equal(p.numpy(), p0)
    assert state.count == 6


def test_optimizer_schedules_match_optax():
    for steps, frac in ((10, 0.05), (37, 0.2), (3, 0.5)):
        opt = make_optimizer(3e-4, steps=steps, schedule="cosine", warmup_frac=frac)
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=3e-4, warmup_steps=max(1, int(steps * frac)),
            decay_steps=steps, end_value=3e-5)
        for count in range(steps + 2):
            np.testing.assert_allclose(float(opt.lr(count)), float(want(count)), rtol=1e-6,
                                       atol=1e-12)
    with pytest.raises(ValueError, match="schedule"):
        make_optimizer(1e-3, schedule="linear")
    with pytest.raises(ValueError, match="total steps"):
        make_optimizer(1e-3, schedule="cosine")


# --- the train step, the loop and the entry point ---------------------------

TRAIN_KW = dict(steps=4, batch=4, seq=SEQ, lr=3e-3, seed=5)
# after four Adam steps: Adam divides each gradient element by its own
# magnitude, so an element the two packages round to nearly 0 can move
# its weight by up to lr·|Δg|/eps
TRAIN_WEIGHT_ATOL = 2e-5


@pytest.mark.parametrize("case", ["constant", "cosine_clip_chunked"])
def test_train_matches_jax(case):
    """``train`` from the same leaves: the per-step losses and the weights
    after the last step."""
    kw = dict(TRAIN_KW)
    if case != "constant":
        kw.update(schedule="cosine", grad_clip=0.05, logit_chunk=8)
    corpus = lm.synthetic_corpus(3000, VOCAB, seed=1)
    jm = _tiny()
    pm = port_of(jm)
    j_model, j_losses = j_train(jm, corpus, **kw)
    p_model, losses = train(pm, corpus, **kw)
    assert p_model is pm and len(losses) == len(j_losses) == kw["steps"]
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for p, jp in zip(p_model.leaves(), j_leaves(j_model)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0,
                                   atol=TRAIN_WEIGHT_ATOL)


def test_train_step_returns_a_device_scalar_loss():
    pm = port_of(_tiny())
    opt = make_optimizer(1e-3)
    state = opt.init(pm.leaves())
    toks = torch.from_numpy(_tokens(6))
    model, state, loss = make_train_step(opt)(pm, state, toks)
    assert model is pm and state.count == 1
    assert isinstance(loss, torch.Tensor) and loss.shape == () and not loss.requires_grad
    assert all(p.requires_grad for p in pm.leaves())


@pytest.mark.parametrize("corpus", [False, True], ids=["synthetic", "text_corpus"])
def test_lm_transformer_main_matches_jax(monkeypatch, tmp_path, corpus):
    """``main(argv, device="cpu")`` against the JAX package's ``main`` on
    the same argv. The JAX model's leaves are carried into the port's
    ``TransformerLM.create`` (the two packages' random draws differ); the
    result's keys, losses and held-out perplexity agree."""
    argv = ["--steps", "3", "--batch", "2", "--seq", str(SEQ), "--dim", "32", "--depth", "2",
            "--num-heads", "4", "--vocab", str(VOCAB), "--lr", "3e-3", "--seed", "2"]
    if corpus:
        path = tmp_path / "corpus.txt"
        path.write_bytes(bytes(np.random.default_rng(7).integers(32, 127, size=1200)
                               .astype(np.uint8)))
        argv += ["--corpus", str(path)]
    made = {}

    def carried(**kw):
        kw.pop("device"), kw.pop("generator")
        made["jax"] = jlm.TransformerLM.create(jax.random.key(2), **kw)
        return port_of(made["jax"])

    monkeypatch.setattr(lm_transformer.TransformerLM, "create", staticmethod(carried))
    got = lm_transformer.main(argv, device="cpu")
    want = jlm.main(argv)
    assert set(got) == set(want)
    for key in ("steps", "steps_ran", "resumed", "params"):
        assert got[key] == want[key], key
    for key in ("loss_first", "loss_last") + (
            ("valid_loss", "valid_perplexity", "valid_bits_per_token") if corpus else ()):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)


def test_step_batch_and_flops_match_jax():
    corpus = lm.synthetic_corpus(1000, VOCAB, seed=3)
    for seed, i in ((0, 0), (5, 17), (2**31, 3)):
        np.testing.assert_array_equal(
            _step_batch(corpus, seed, i, 4, SEQ), j_step_batch(corpus, seed, i, 4, SEQ))
    for kw in (dict(), dict(pos_encoding="rope", num_kv_heads=2)):
        jm = _tiny(**kw)
        assert lm.train_step_flops(port_of(jm), 8, 128) == j_flops(jm, 8, 128)


def test_unported_train_options_raise(monkeypatch, tmp_path):
    """None of train's options is ignored. ``checkpoint_dir`` is ported
    (tests/test_torch_lm_resume.py holds the resume), and so are the
    guard, the step watchdog, data parallelism across processes and tensor
    parallelism: a model sharded over a model axis trains as the whole
    model does (tests/test_torch_tensor_parallel.py holds it against the
    JAX package's sharded train)."""
    pm = port_of(_tiny())
    corpus = lm.synthetic_corpus(500, VOCAB)
    kw = dict(steps=1, batch=4, seq=SEQ)
    _, ran = train(pm, corpus, **kw, checkpoint_dir=str(tmp_path / "ck"))
    assert len(ran) == 1 and (tmp_path / "ck" / "step_1").is_dir()
    # the guard and the step watchdog are ported (tests/test_torch_guards.py
    # holds them against the JAX package): asked for, they run
    for extra in (dict(guard="skip"), dict(step_timeout_s=5.0)):
        assert len(train(pm, corpus, **kw, **extra)[1]) == 1
    for env in ("KEYSTONE_GUARD", "KEYSTONE_STEP_TIMEOUT_S"):
        monkeypatch.setenv(env, "skip" if env == "KEYSTONE_GUARD" else "3")
        assert len(train(pm, corpus, **kw)[1]) == 1
        monkeypatch.delenv(env)
    # a one-process mesh whose data axis names several cards trains the
    # batch on the model's device, as a mesh of one position does
    two = port_of(_tiny())
    _, on_mesh = train(two, corpus, **kw, mesh=create_mesh(data=2, devices=["cpu"] * 2))
    _, alone = train(port_of(_tiny()), corpus, **kw)
    assert on_mesh == alone
    # a job of several processes trains data-parallel over the process
    # group (tests/test_torch_multihost.py); without one it raises
    monkeypatch.setenv("KEYSTONE_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        train(pm, corpus, **kw)
    monkeypatch.delenv("KEYSTONE_NUM_PROCESSES")
    sharded = lm.shard_params(port_of(_tiny()), create_mesh(data=1, model=2, devices=["cpu"] * 2))
    assert sharded.tp is not None and sharded.tp.attn and sharded.tp.ffn
    _, tp_losses = train(sharded, corpus, **kw)
    np.testing.assert_allclose(tp_losses, alone, rtol=LOSS_RTOL)
    assert lm.shard_params(pm, create_mesh(data=2, devices=["cpu"] * 2)) is pm
    # --moe-every trains a MoE model with the JAX package's parameter count
    moe_argv = ["--moe-every", "2", "--num-experts", "4", "--steps", "2", "--batch", "2",
                "--seq", "16", "--dim", "32", "--depth", "2", "--num-heads", "4", "--vocab", "31"]
    res, j_res = lm_transformer.main(moe_argv, device="cpu"), jlm.main(moe_argv)
    assert res.keys() == j_res.keys() and res["params"] == j_res["params"]
    assert res["steps_ran"] == 2 and np.isfinite(res["loss_first"])
    with pytest.raises(ValueError, match="schedule"):
        lm_transformer.main(["--schedule", "linear"], device="cpu")
