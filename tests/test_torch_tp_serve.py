"""keystone_tpu_torch's serving of a tensor-parallel LM against the JAX
package's, on the CPU, in one process.

The JAX side shards its tiny models with ``shard_params`` over the model
axis of the conftest's 8 virtual devices and serves them as they are
(GSPMD carries the layout through ``prefill``, ``decode_step``,
``generate`` and ``export_lm``). The port shards the same weights, carried
across with ``convert.transformer_lm``, over
``create_mesh(data=1, model=n, devices=["cpu"] * n)``. Held against each
other: prefill logits within FWD_TOL and teacher-forced decode within
DECODE_TOL of max|logit| (``tests/test_torch_lm.py``'s bars) for model axes
2 and 4; greedy ``generate`` tokens for the dense model, the MoE model
(routers scaled by 25 and the routing gap asserted, as
``tests/test_torch_moe.py`` does), grouped-query heads that straddle the
shards, an int8 KV cache and per-row prompt lengths; quantization after
sharding, codes and scales bit for bit; the exported slot pool's tokens;
and the ``ValueError`` of sharding an int8 model in both packages. Inputs
come from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.models import lm_transformer as jlm  # noqa: E402
from keystone_tpu.parallel.mesh import create_mesh as j_create_mesh  # noqa: E402
from keystone_tpu.serve.export import export_lm as j_export_lm  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.models import lm  # noqa: E402
from keystone_tpu_torch.models.lm import decode  # noqa: E402
from keystone_tpu_torch.ops.quantization import QTensor  # noqa: E402
from keystone_tpu_torch.parallel import create_mesh  # noqa: E402
from keystone_tpu_torch.serve.export import export_lm  # noqa: E402

# tests/test_torch_lm.py's and tests/test_torch_moe.py's bars
FWD_TOL = 1e-5
DECODE_TOL = 1e-4
ROUTER_SCALE, ROUTE_MARGIN = 25.0, 1e-4
VOCAB = 64
CONF = dict(vocab=VOCAB, max_seq=48, dim=64, depth=2, num_heads=4)


def _jax_model(**kw):
    jm = jlm.TransformerLM.create(jax.random.key(0), **{**CONF, **kw})
    if jm.moe_layers:
        jm = dataclasses.replace(jm, moe_layers=tuple(
            None if m is None else dataclasses.replace(m, w_router=m.w_router * ROUTER_SCALE)
            for m in jm.moe_layers))
    return jm


def _port_of(jm) -> lm.TransformerLM:
    leaves = {
        "embed": jm.embed, "pos_embed": jm.pos_embed,
        "blocks": [{n: getattr(b, n) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                   for b in jm.blocks],
        "moe_layers": [None if m is None else dict(
            w_router=m.w_router, w1=m.w1, w2=m.w2, capacity_factor=m.capacity_factor,
            group_size=m.group_size) for m in jm.moe_layers],
    }
    return convert.transformer_lm(leaves, num_heads=jm.num_heads, num_kv_heads=jm.num_kv_heads,
                                  pos_encoding=jm.pos_encoding, device="cpu")


def _pair(n: int, **kw):
    """(JAX model sharded over a (8/n, n) mesh, the port's sharded over n
    CPU positions, the port's whole model)."""
    jm = _jax_model(**kw)
    pm = _port_of(jm)
    sharded = lm.shard_params(pm, create_mesh(data=1, model=n, devices=["cpu"] * n))
    return jlm.shard_params(jm, j_create_mesh(data=8 // n, model=n)), sharded, pm


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape)


def _close(got, want, tol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err:.3e} of max {np.abs(want).max():.3e}"


def _routes_margin(pm, fn) -> float:
    """The smallest top-1/top-2/top-3 router-logit gap over every MoE input
    that ``fn`` runs through ``pm``."""
    seen = []
    handles = [m.register_forward_hook(lambda mod, args, out: seen.append((mod, args[0])))
               for m in pm.experts]
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    assert seen
    margins = []
    for mod, y in seen:
        logits = (y.detach().to(torch.float64).reshape(-1, y.shape[-1])
                  @ mod.w_router.detach().to(torch.float64))
        ls = torch.sort(logits, dim=-1, descending=True).values
        margins.append(float((ls[:, :2] - ls[:, 1:3]).min()))
    return out, min(margins)


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_prefill_and_decode_match_jax(n_model):
    """f32 prefill logits within FWD_TOL, then teacher-forced decode steps
    within DECODE_TOL of max|logit|, against the JAX package's sharded
    model; the port's cache is whole in one process, head-split by
    position."""
    jm, pm, _ = _pair(n_model)
    toks = _toks(9, (3, 22))
    n_prompt, s_max = 12, 22
    jl, jc = jax.jit(jlm.prefill, static_argnums=2)(jm, jnp.asarray(toks[:, :n_prompt]), s_max)
    pl, pc = decode.prefill(pm, torch.from_numpy(toks[:, :n_prompt]), s_max)
    assert tuple(pc.k.shape) == tuple(jc.k.shape)
    _close(pl.numpy(), jl, FWD_TOL, "prefill")
    j_decode = jax.jit(jlm.decode_step)
    for j in range(n_prompt, s_max - 1):
        jl, jc = j_decode(jm, jnp.asarray(toks[:, j]), jc)
        pl, pc = decode.decode_step(pm, torch.from_numpy(toks[:, j]), pc)
        _close(pl.numpy(), jl, DECODE_TOL, f"decode step {j}")


@pytest.mark.parametrize("case", ["dense", "moe", "gqa_straddling", "int8_kv", "prompt_lens"])
def test_sharded_generate_matches_jax(case):
    """Greedy ``generate`` of a model sharded over a model axis of 4: the
    tokens equal the JAX package's. The MoE model's routers are scaled by 25
    and every routing gap exceeds 1e-4; 2 KV heads over 4 positions keep the
    attention whole."""
    kw = {"moe": dict(moe_every=2, num_experts=4),
          "gqa_straddling": dict(num_kv_heads=2)}.get(case, {})
    jm, pm, _ = _pair(4, **kw)
    assert pm.tp.attn == (case != "gqa_straddling")
    prompt = _toks(3, (3, 10))
    gen = dict(max_new=12)
    if case == "int8_kv":
        gen["kv_dtype"] = "int8"
    if case == "prompt_lens":
        gen["prompt_lens"] = np.array([10, 4, 7])
    want = np.asarray(jlm.generate(jm, jnp.asarray(prompt), **{
        k: jnp.asarray(v) if k == "prompt_lens" else v for k, v in gen.items()}))
    run = lambda: lm.generate(pm, torch.from_numpy(prompt), **{  # noqa: E731
        k: torch.from_numpy(v) if k == "prompt_lens" else v for k, v in gen.items()})
    if case == "moe":
        got, margin = _routes_margin(pm, run)
        assert margin > ROUTE_MARGIN
    else:
        got = run()
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_after_shard_matches_jax():
    """``quantize_for_decode(shard_params(...))`` in both packages: the
    port's codes and scales equal the JAX package's bit for bit (the
    positions' pieces joined back equal them too), and the quantized
    sharded models generate the same tokens."""
    jm, pm, _ = _pair(4)
    jq, pq = jlm.quantize_for_decode(jm), lm.quantize_for_decode(pm)
    j_leaves = [jq.embed] + [getattr(b, n) for b in jq.blocks
                             for n in ("wq", "wk", "wv", "wo", "w1", "w2")]
    p_leaves = [pq.embed] + [getattr(b, n) for b in pq.blocks
                             for n in ("wq", "wk", "wv", "wo", "w1", "w2")]
    for jw, pw in zip(j_leaves, p_leaves):
        assert isinstance(pw, QTensor)
        np.testing.assert_array_equal(pw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(pw.scale.numpy(), np.asarray(jw.scale))
    tp = pq.tp
    for w, dim in ((pq.blocks[0].wq, 1), (pq.blocks[0].wo, 0), (pq.embed, 0)):
        pieces = [tp.part(w, dim, p, "cpu") for p in range(tp.n)]
        assert all(p.q.is_contiguous() for p in pieces)
        assert torch.equal(torch.cat([p.q for p in pieces], dim=dim), w.q)
    assert pq.num_params() == jq.num_params()
    prompt = _toks(4, (2, 8))
    want = np.asarray(jlm.generate(jq, jnp.asarray(prompt), max_new=10, kv_dtype="int8"))
    for kernel in ("mm", "kernel"):
        got = lm.generate(pq.replace(int8_kernel=kernel), torch.from_numpy(prompt), max_new=10,
                          kv_dtype="int8")
        np.testing.assert_array_equal(got.numpy(), want)


def test_export_lm_of_sharded_model_matches_jax():
    """``export_lm(sharded, quantize=True)``'s slot pool in both packages:
    the same tokens for prompts of unequal length."""
    jm, pm, _ = _pair(2)
    prompts = [_toks(10 + i, (n,)) for i, n in enumerate((5, 9, 3))]
    kw = dict(slots=2, s_max=32, quantize=True, max_new=6)
    want = j_export_lm(jm, **kw).run(prompts)
    loop = export_lm(pm, **kw)
    assert loop.model.tp is not None and not loop.graphed
    for g, w in zip(loop.run(prompts), want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_shard_params_of_int8_model_raises_in_both():
    """Sharding after quantizing: the JAX package's ``device_put`` of a
    (1, N) scale over the model axis raises ``ValueError``, and so does
    the port's ``shard_params``, naming the order that works."""
    jm = _jax_model()
    with pytest.raises(ValueError):
        jlm.shard_params(jlm.quantize_for_decode(jm), j_create_mesh(data=2, model=4))
    with pytest.raises(ValueError, match="quantize_for_decode\\(shard_params"):
        lm.shard_params(lm.quantize_for_decode(_port_of(jm)),
                        create_mesh(data=1, model=4, devices=["cpu"] * 4))
