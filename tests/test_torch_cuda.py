"""keystone_tpu_torch on an NVIDIA card: the CUDA kernels against their
plain versions, and the CUDA staging path against the CPU one.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device. The file imports only torch, numpy and the port, so it also runs
on a machine without JAX; there, run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import json
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keystone_tpu_torch.core.batching import apply_in_chunks  # noqa: E402
from keystone_tpu_torch.core.staging import fold_staged  # noqa: E402
from keystone_tpu_torch.ops import gram  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d", [(1000, 300), (8192, 1024), (7, 5), (513, 129), (0, 64)])
def test_k1_matches_plain_bit_for_bit(card, n, d):
    gen = torch.Generator(device=card).manual_seed(n + d)
    q = torch.randint(-127, 128, (n, d), dtype=torch.int8, device=card, generator=gen)
    before = gram.INT8_GRAM.launches
    got = gram.int8_gram(q)
    torch.cuda.synchronize()
    assert gram.INT8_GRAM.launches == before + 1
    assert torch.equal(got, gram.int8_gram_plain(q))


@pytest.mark.parametrize("n,d", [(1001, 1), (517, 127), (999, 300), (1003, 1000), (0, 127), (8192, 136)])
def test_k1_is_the_exact_integer_gram_and_symmetric(card, n, d):
    """K1 is ata_int8_xla's integer form, qᵀq contracted exactly and
    rounded once to f32, bit for bit: at N % 16 ≠ 0 (qᵀ's padded pitch),
    ragged D, N = 0 and past 2²⁴ (8,192 rows of ±127 on the diagonal); and
    (i, j) and (j, i) hold the same bits."""
    gen = torch.Generator(device=card).manual_seed(7 * n + d)
    q = torch.randint(-127, 128, (n, d), dtype=torch.int8, device=card, generator=gen)
    if n == 8192:
        q[:, :8] = 127
    got = gram.int8_gram(q)
    torch.cuda.synchronize()
    integer = (q.cpu().long().T @ q.cpu().long()).float()
    assert torch.equal(got.cpu(), integer)
    assert torch.equal(got, got.T)


def test_k1_wrapper_rejects_non_contiguous(card):
    q = torch.zeros((64, 32), dtype=torch.int8, device=card).t()
    with pytest.raises(ValueError):
        gram.int8_gram(q)


def test_ata_int8_on_card_matches_cpu(card):
    a = np.random.default_rng(0).normal(size=(1500, 200)).astype(np.float32)
    cpu = gram.ata_int8(torch.from_numpy(a))
    dev = gram.ata_int8(torch.from_numpy(a).to(card)).cpu()
    torch.testing.assert_close(dev, cpu, rtol=1e-5, atol=1e-5 * float(cpu.abs().max()))


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_staged_chunks_arrive_intact(card, depth):
    rows = np.random.default_rng(1).normal(size=(1000, 17)).astype(np.float32)
    labels = np.arange(1000, dtype=np.float32)[:, None]

    def chunks():
        for s in range(0, 1000, 96):
            yield (rows[s : s + 96], labels[s : s + 96]), min(96, 1000 - s)

    def fold(acc, staged, valid):
        a, b = staged
        assert a.is_cuda and b.is_cuda
        return acc + torch.cat([a, b], dim=1)[:valid].sum(0)

    total = fold_staged(chunks(), fold, torch.zeros(18, device=card), card, stage_depth=depth)
    want = np.concatenate([rows, labels], axis=1).sum(0)
    np.testing.assert_allclose(total.cpu().numpy(), want, rtol=1e-5)


def test_cost_probe_does_not_hide_a_runtime_error_on_card(card):
    from keystone_tpu_torch.core.pipeline import Pipeline, transformer
    from keystone_tpu_torch.plan import costs
    from keystone_tpu_torch.plan.ir import chain_from

    def fails(batch):
        raise RuntimeError("device fault")

    chain = chain_from(Pipeline.of(transformer(fails, "fails")))
    with pytest.raises(RuntimeError, match="device fault"):
        costs.sample_chain(chain, torch.ones(8, 4), card)


def test_apply_in_chunks_on_card_matches_cpu(card):
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1000, 8)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 3)).astype(np.float32))
    got = apply_in_chunks(lambda b: b @ w.to(card), x, 128, card)
    assert got.shape == (1000, 3) and got.is_cuda
    torch.testing.assert_close(got.cpu(), x @ w, rtol=1e-5, atol=1e-5)


# --- K2, flash attention ----------------------------------------------------

K2_BF16_TOL = 8e-3  # of max|plain|: one bf16 step after an f32 sum in another order
K2_F32_TOL = 1e-5
K4_BF16_TOL = 8e-3
K4_F32_TOL = 1e-5


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _qkv(card, seed, b, h, s_q, s_k, d, dtype):
    gen = torch.Generator(device=card).manual_seed(seed)
    return tuple(
        torch.randn((b, h, s, d), generator=gen, device=card).to(dtype) for s in (s_q, s_k, s_k)
    )


@pytest.mark.parametrize(
    "shape,dtype,causal,offsets",
    [
        ((8, 16, 128, 128, 64), torch.bfloat16, True, (0, 0)),  # LM prefill
        ((8, 16, 2048, 2048, 64), torch.bfloat16, True, (0, 0)),  # max_seq
        ((2, 3, 77, 50, 40), torch.float32, False, (5, 3)),  # ragged, offsets
        ((2, 3, 77, 50, 40), torch.float32, True, (3, 40)),  # fully masked rows
        ((1, 4, 300, 200, 128), torch.bfloat16, False, (0, 0)),  # D = 128
        ((2, 2, 100, 130, 36), torch.bfloat16, True, (0, 30)),  # D not a multiple of 8
        ((1, 2, 65, 65, 100), torch.float32, True, (0, 0)),
        # the tiled f32 kernel (S_k > 64)
        ((8, 8, 256, 256, 32), torch.float32, True, (0, 0)),  # the trainer's default
        ((2, 2, 130, 200, 64), torch.float32, True, (5, 90)),  # offsets: rows 0-84 fully masked
        ((1, 3, 333, 129, 128), torch.float32, False, (0, 0)),
        ((3, 2, 97, 97, 33), torch.float32, True, (0, 0)),  # rows not 16-byte aligned
        ((2, 3, 20, 100, 40), torch.float32, True, (0, 70)),  # every row fully masked
        # the Hopper tiles: 192 q rows a block (128 at D > 64), 64 keys
        ((1, 3, 200, 333, 64), torch.bfloat16, True, (70, 30)),  # ragged S, offsets
        ((2, 2, 191, 193, 64), torch.bfloat16, False, (0, 0)),  # one row short of a block
        ((1, 2, 385, 260, 64), torch.bfloat16, True, (125, 0)),
        ((2, 2, 257, 257, 128), torch.bfloat16, True, (5, 69)),  # D = 128, causal
        ((1, 3, 150, 97, 36), torch.bfloat16, False, (3, 1)),  # D padded to 40
        ((1, 2, 70, 90, 100), torch.bfloat16, True, (0, 0)),  # D padded to 104
        # f32 with every key in one 64-key tile: the short-key kernel
        ((512, 4, 16, 16, 32), torch.float32, False, (0, 0)),  # ViT's call
        ((336, 4, 16, 16, 32), torch.float32, False, (0, 0)),  # ViT's last train chunk
        ((1, 1, 1, 1, 8), torch.float32, False, (0, 0)),
        ((2, 3, 17, 64, 40), torch.float32, True, (3, 40)),  # every row fully masked
        ((3, 5, 70, 20, 32), torch.float32, False, (0, 0)),  # S_q > 64: two q tiles
        ((1, 2, 64, 64, 128), torch.float32, False, (0, 0)),
        ((1, 2, 16, 65, 32), torch.float32, False, (0, 0)),  # the first shape past it
        ((7, 1, 16, 16, 32), torch.float32, False, (0, 0)),  # B·H not a multiple of a block's heads
        ((3, 3, 5, 7, 33), torch.float32, True, (2, 0)),  # rows not 16-byte aligned
    ],
)
def test_k2_matches_plain(card, shape, dtype, causal, offsets):
    from keystone_tpu_torch.ops import flash_attention as fa

    b, h, s_q, s_k, d = shape
    q, k, v = _qkv(card, sum(shape), b, h, s_q, s_k, d, dtype)
    kw = dict(causal=causal, q_offset=offsets[0], k_offset=offsets[1], return_lse=True)
    before = fa.FLASH_ATTENTION.launches
    out, lse = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION.launches == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == (b, h, s_q, d)
    tol = K2_F32_TOL if dtype == torch.float32 else K2_BF16_TOL
    assert _rel(out, ref) <= tol
    # the lse is f32 in both dtypes, from scores of the same rounded q, k
    live = ref_lse > -1e29
    scale = max(1.0, float(ref_lse[live].abs().max())) if bool(live.any()) else 1.0
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * scale
    assert torch.all(out[~live] == 0)


@pytest.mark.parametrize("shape,causal", [((2, 2, 200, 300, 64), True),
                                          ((1, 2, 130, 130, 32), False)])
def test_k2_f32_tiled_holds_at_large_scores(card, shape, causal):
    """The tiled f32 kernel's exponentials at scores tens apart: q times 8
    spreads a row's scores over about ±25, where an exponential off by
    |x|·2^-24 relative would show first; out within K2_F32_TOL of the
    plain version, the lse within 1e-5 of max(1, |lse|)."""
    from keystone_tpu_torch.ops import flash_attention as fa

    b, h, s_q, s_k, d = shape
    q, k, v = _qkv(card, sum(shape) + 1, b, h, s_q, s_k, d, torch.float32)
    out, lse = fa.flash_attention(8 * q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(8 * q, k, v, causal=causal, return_lse=True)
    assert _rel(out, ref) <= K2_F32_TOL
    scale = max(1.0, float(ref_lse.abs().max()))
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * scale


def test_k2_bf16_in_f32_out(card):
    from keystone_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(card, 3, 2, 2, 96, 96, 64, torch.float32)
    out = fa.flash_attention(q, k, v, causal=True, mxu_dtype=torch.bfloat16)
    ref = fa.flash_attention_plain(
        *(x.to(torch.bfloat16) for x in (q, k, v)), causal=True, out_dtype=torch.float32
    )
    assert out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-5


@pytest.mark.parametrize("d", [36, 64, 128])
def test_k2_bf16_in_f32_out_with_lse_and_masked_rows(card, d):
    """bf16 in, f32 out, with the lse, on the Hopper path: rows whose
    position precedes every key output 0 and an lse of −1e30. The output is
    held at the bf16 tolerance: both sides round p to bf16, and an
    exponential an ulp apart can round one p to the neighbouring bf16
    value (one bf16 step; it reads 2.6e-4 at D = 36 on an H100). The lse
    takes f32 p and stays at 1e-5."""
    from keystone_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(card, d, 1, 3, 203, 150, d, torch.float32)
    kw = dict(causal=True, q_offset=2, k_offset=70, return_lse=True)
    out, lse = fa.flash_attention(q, k, v, mxu_dtype=torch.bfloat16, **kw)
    ref, ref_lse = fa.flash_attention_plain(
        *(x.to(torch.bfloat16) for x in (q, k, v)), out_dtype=torch.float32, **kw
    )
    dead = 2 + torch.arange(203, device=card) < 70
    assert out.dtype == torch.float32 and _rel(out, ref) <= K2_BF16_TOL
    assert torch.all(out[:, :, dead] == 0) and torch.all(lse[:, :, dead] <= -1e29)
    live = ref_lse[:, :, ~dead]
    assert float((lse[:, :, ~dead] - live).abs().max()) <= 1e-5 * max(1.0, float(live.abs().max()))


@pytest.mark.parametrize("shape", [(1, 2, 64, 128), (1, 2, 200, 64)], ids=["short_keys", "tiled"])
def test_k2_f32_launches_on_a_second_card(card, shape):
    """Both f32 kernels opt in to more than 48 KB of shared memory (about
    100 KB and 224 KB at these shapes) on each card they launch on: a
    process that launched on card 0 launches on card 1 too, and each
    card's result is its plain version's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards in one process")
    from keystone_tpu_torch.ops import flash_attention as fa

    for index in (0, 1):
        dev = torch.device("cuda", index)
        q, k, v = _qkv(dev, index, *shape[:3], shape[2], shape[3], torch.float32)
        before = fa.FLASH_ATTENTION.launches
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize(dev)
        assert fa.FLASH_ATTENTION.launches == before + 1 and out.device == dev
        assert _rel(out, fa.flash_attention_plain(q, k, v, causal=True)) <= K2_F32_TOL


def test_k2_wrapper_rejects_bad_inputs(card):
    from keystone_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(card, 4, 1, 2, 16, 16, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*_qkv(card, 5, 1, 1, 8, 8, 160, torch.float32))


# --- K4, int8-dequant matmul ------------------------------------------------


@pytest.mark.parametrize(
    "m,k,n",
    [(8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024), (64, 1024, 4096), (3, 1000, 300),
     (256, 96, 40), (1, 7, 5)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(card, m, k, n, dtype):
    from keystone_tpu_torch.ops import int8_matmul as im
    from keystone_tpu_torch.ops.quantization import quantize_int8

    gen = torch.Generator(device=card).manual_seed(m + k + n)
    w = quantize_int8(torch.randn((k, n), generator=gen, device=card))
    y = torch.randn((m, k), generator=gen, device=card).to(dtype)
    before = im.INT8_MATMUL.launches
    got = im.mm_fused(y, w)
    torch.cuda.synchronize()
    assert im.INT8_MATMUL.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    tol = K4_F32_TOL if dtype == torch.float32 else K4_BF16_TOL
    assert _rel(got, im.mm_fused_plain(y, w)) <= tol
    # the same inputs give the same bits: the split sums run in a fixed order
    assert torch.equal(got, im.mm_fused(y, w))


def test_k4_route_above_256_rows_is_no_launch(card):
    from keystone_tpu_torch.ops import int8_matmul as im
    from keystone_tpu_torch.ops.quantization import mm, quantize_int8

    w = quantize_int8(torch.randn((64, 32), device=card))
    y = torch.randn((300, 64), device=card)
    before = im.INT8_MATMUL.launches
    assert torch.equal(im.mm_fused(y, w), mm(y, w, torch.float32))
    assert im.INT8_MATMUL.launches == before


def test_k4_graph_replays_give_the_eager_bits(card):
    """One launch a call and nothing carried between launches: three
    replays of a captured call give the eager call's bits."""
    from keystone_tpu_torch.ops import int8_matmul as im
    from keystone_tpu_torch.ops.quantization import quantize_int8

    gen = torch.Generator(device=card).manual_seed(11)
    w = quantize_int8(torch.randn((1024, 4096), generator=gen, device=card))
    y = torch.randn((8, 1024), generator=gen, device=card).to(torch.bfloat16)
    eager = im.mm_fused(y, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = im.INT8_MATMUL.launches
    with torch.cuda.graph(graph):
        captured = im.mm_fused(y, w)
    assert im.INT8_MATMUL.launches == before + 1
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_alternating_shapes(card, dtype):
    """Calls of other shapes in turn (each its own plan) stay right and
    repeat their bits."""
    from keystone_tpu_torch.ops import int8_matmul as im
    from keystone_tpu_torch.ops.quantization import quantize_int8

    gen = torch.Generator(device=card).manual_seed(12)
    ws = [quantize_int8(torch.randn((k, n), generator=gen, device=card))
          for k, n in ((1024, 1024), (1024, 4096), (4096, 1024))]
    tol = K4_F32_TOL if dtype == torch.float32 else K4_BF16_TOL
    first = {}
    for rnd in range(2):
        for m in (1, 8, 64, 256):
            for i, w in enumerate(ws):
                y = torch.randn((m, w.q.shape[0]), generator=torch.Generator(device=card).manual_seed(m + i),
                                device=card).to(dtype)
                got = im.mm_fused(y, w)
                if rnd == 0:
                    assert _rel(got, im.mm_fused_plain(y, w)) <= tol
                    first[(m, i)] = got
                else:
                    assert torch.equal(got, first[(m, i)])


def test_k4_wrapper_rejects_bad_inputs(card):
    from keystone_tpu_torch.ops import int8_matmul as im
    from keystone_tpu_torch.ops.quantization import quantize_int8

    w = quantize_int8(torch.randn((64, 32), device=card))
    y = torch.randn((64, 4), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        im.mm_fused(y.t(), w)
    with pytest.raises(TypeError):
        im.mm_fused(y.t().contiguous().half(), w)


# --- the LM serving path ----------------------------------------------------


def _tiny_lm_pair(card):
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.models.lm import TransformerLM, quantize_for_decode

    cpu = quantize_for_decode(
        TransformerLM.create(vocab=97, max_seq=64, dim=64, depth=2, num_heads=4, device="cpu")
    )

    def leaf(x):
        return x if hasattr(x, "q") else x.detach().numpy()

    leaves = {
        "embed": leaf(cpu.embed),
        "pos_embed": leaf(cpu.pos_embed),
        "blocks": [dict(zip(("wq", "wk", "wv", "wo", "w1", "w2"), map(leaf, b.leaves())))
                   for b in cpu.blocks],
    }
    dev = convert.transformer_lm(leaves, num_heads=4, int8_kernel="pallas", device=card)
    return cpu, dev


def test_tiny_lm_on_card_matches_cpu(card):
    """f32: flash (K2) and K4 on the card against dense attention and the
    plain int8 matmul on the CPU."""
    from keystone_tpu_torch.models.lm import decode, generate
    from keystone_tpu_torch.ops import flash_attention, int8_matmul

    cpu, dev = _tiny_lm_pair(card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 97, size=(3, 24)))
    k2, k4 = flash_attention.FLASH_ATTENTION.launches, int8_matmul.INT8_MATMUL.launches
    lc, cc = decode.prefill(cpu, toks[:, :12], 24)
    ld, cd = decode.prefill(dev, toks[:, :12].to(card), 24)
    torch.testing.assert_close(ld.cpu(), lc, rtol=0, atol=1e-4)
    for j in range(11):
        lc, cc = decode.decode_step(cpu, toks[:, 12 + j], cc)
        ld, cd = decode.decode_step(dev, toks[:, 12 + j].to(card), cd)
        torch.testing.assert_close(ld.cpu(), lc, rtol=0, atol=1e-4)
    assert flash_attention.FLASH_ATTENTION.launches == k2 + 2  # one per layer
    # 36 prefill rows and every decode step are at most 64 rows: K4 throughout
    assert int8_matmul.INT8_MATMUL.launches == k4 + 6 * 2 * 12
    got = generate(dev, toks[:, :8].to(card), max_new=8)
    want = generate(cpu, toks[:, :8], max_new=8)
    assert got.is_cuda and (got.cpu() == want).float().mean() >= 0.9


# --- K3, the ring hop ---------------------------------------------------------

K3_TOL = 1e-5  # of max|plain|: f32 arithmetic summed in another order


def _k3_inputs(card, seed, b, h, s_q, s_k, d, dtype, fresh):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=card).to(dtype)
               for s in (s_q, s_k, s_k))
    if fresh:
        state = (torch.full((b, h, s_q), -1e30, device=card), torch.zeros((b, h, s_q), device=card),
                 torch.zeros((b, h, s_q, d), device=card))
    else:
        state = (torch.randn((b, h, s_q), generator=gen, device=card),
                 torch.rand((b, h, s_q), generator=gen, device=card) + 0.5,
                 torch.randn((b, h, s_q, d), generator=gen, device=card))
    return (q, k, v), state


def _k3_close(got, want, state_in):
    """m on rows some key reached (a row no key reached keeps its m bit
    for bit), l and acc everywhere, each within K3_TOL of max|plain|."""
    m, l, acc = got
    m_ref, l_ref, acc_ref = want
    live = m_ref > -1e29
    assert torch.equal(m[~live], m_ref[~live])
    if bool(live.any()):
        assert _rel(m[live], m_ref[live]) <= K3_TOL
    assert _rel(l, l_ref) <= K3_TOL
    assert _rel(acc, acc_ref) <= K3_TOL
    assert all(x.dtype == torch.float32 for x in got)
    assert not any(g.data_ptr() == x.data_ptr() for g, x in zip(got, state_in))


@pytest.mark.parametrize(
    "shape,dtype,causal,offsets,fresh",
    [
        ((2, 16, 2048, 2048, 64), torch.bfloat16, True, (2048, 2048), True),  # diagonal hop
        ((2, 16, 2048, 2048, 64), torch.bfloat16, True, (4096, 0), False),  # past hop
        ((1, 3, 777, 500, 40), torch.float32, True, (100, 300), False),  # rows fully masked
        ((1, 3, 777, 500, 40), torch.float32, False, (0, 300), True),
        ((1, 2, 130, 200, 128), torch.bfloat16, False, (0, 0), False),  # D = 128
        ((2, 2, 100, 130, 36), torch.bfloat16, True, (64, 30), True),  # D not a multiple of 4
        ((1, 2, 33, 0, 16), torch.float32, False, (0, 0), False),  # an empty K/V block
        # the Hopper tiles, carried state: a ragged diagonal hop, offsets not
        # multiples of 64, D = 128 and padded D
        ((1, 3, 333, 333, 64), torch.bfloat16, True, (333, 333), False),
        ((2, 2, 200, 130, 64), torch.bfloat16, True, (100, 37), False),
        ((1, 2, 200, 150, 128), torch.bfloat16, True, (100, 37), False),
        ((1, 2, 150, 100, 100), torch.bfloat16, False, (0, 0), False),
        ((1, 2, 33, 0, 64), torch.bfloat16, False, (0, 0), False),  # an empty K/V block
    ],
)
def test_k3_matches_plain(card, shape, dtype, causal, offsets, fresh):
    from keystone_tpu_torch.ops import flash_attention as fa

    b, h, s_q, s_k, d = shape
    qkv, state = _k3_inputs(card, sum(shape), b, h, s_q, s_k, d, dtype, fresh)
    kw = dict(q_offset=offsets[0], k_offset=offsets[1], causal=causal)
    before = fa.FLASH_ATTENTION_STEP.launches
    got = fa.flash_attention_step(*qkv, *state, **kw)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION_STEP.launches == before + 1
    _k3_close(got, fa.flash_attention_step_plain(*qkv, *state, **kw), state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_future_hop_returns_state_bit_for_bit(card, dtype):
    from keystone_tpu_torch.ops import flash_attention as fa

    qkv, state = _k3_inputs(card, 9, 2, 4, 300, 256, 64, dtype, fresh=False)
    got = fa.flash_attention_step(*qkv, *state, q_offset=0, k_offset=300, causal=True)
    torch.cuda.synchronize()
    for g, x in zip(got, state):
        assert torch.equal(g, x) and g.data_ptr() != x.data_ptr()


def test_k3_wrapper_rejects_bad_inputs(card):
    from keystone_tpu_torch.ops import flash_attention as fa

    (q, k, v), (m, l, acc) = _k3_inputs(card, 10, 1, 2, 16, 16, 32, torch.float32, fresh=True)
    kw = dict(q_offset=0, k_offset=0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_step(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, m, l, acc, **kw)
    with pytest.raises(TypeError):
        fa.flash_attention_step(q.half(), k.half(), v.half(), m, l, acc, **kw)
    with pytest.raises(TypeError):
        fa.flash_attention_step(q, k.to(torch.bfloat16), v, m, l, acc, **kw)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_step(q, k, v, m.double(), l, acc, **kw)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention_step(q, k, v, m[:, :, :8], l, acc, **kw)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention_step(q, k, v, m.cpu(), l, acc, **kw)


# --- ring and Ulysses on one card named four times ---------------------------


def test_ring_on_repeated_card_matches_k2(card):
    from keystone_tpu_torch.ops import attention
    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=4, devices=[card] * 4)
    gen = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn((2, 4, 1024, 64), generator=gen, device=card) for _ in range(3))
    before = fa.FLASH_ATTENTION_STEP.launches
    out = attention.ring_attention(q, k, v, mesh, causal=True)
    torch.cuda.synchronize()
    # 4 positions, causal: the 6 hops with a block from a later position
    # have no live key and are not launched
    assert fa.FLASH_ATTENTION_STEP.launches == before + 10
    assert _rel(out, fa.flash_attention(q, k, v, causal=True)) <= K3_TOL
    plain = attention.ring_attention(q, k, v, mesh, causal=True, use_flash=False)
    assert fa.FLASH_ATTENTION_STEP.launches == before + 10
    nc = attention.ring_attention(q, k, v, mesh, causal=False)
    assert fa.FLASH_ATTENTION_STEP.launches == before + 10 + 16
    assert _rel(nc, fa.flash_attention(q, k, v, causal=False)) <= K3_TOL
    assert _rel(out, plain) <= K3_TOL
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    k2 = fa.FLASH_ATTENTION.launches
    uly = attention.ulysses_attention(qb, kb, vb, mesh, causal=True)
    assert fa.FLASH_ATTENTION.launches == k2 + 4
    assert _rel(uly, fa.flash_attention(qb, kb, vb, causal=True)) <= K2_BF16_TOL


def test_cpu_tensors_on_a_card_mesh_launch_the_kernels(card):
    """The fused default reads the mesh: CPU inputs on a mesh of cards run
    K3 (ring) and K2 (Ulysses) there, and come back to the CPU."""
    from keystone_tpu_torch.ops import attention
    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=4, devices=[card] * 4)
    gen = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn((1, 4, 512, 64), generator=gen) for _ in range(3))
    want = fa.flash_attention(q.to(card), k.to(card), v.to(card), causal=True).cpu()
    k3, k2 = fa.FLASH_ATTENTION_STEP.launches, fa.FLASH_ATTENTION.launches
    ring = attention.ring_attention(q, k, v, mesh, causal=True)
    uly = attention.ulysses_attention(q, k, v, mesh, causal=True)
    assert fa.FLASH_ATTENTION_STEP.launches == k3 + 10  # causal: 10 live hops
    assert fa.FLASH_ATTENTION.launches == k2 + 4
    assert ring.device.type == "cpu" and uly.device.type == "cpu"
    assert _rel(ring, want) <= K3_TOL and _rel(uly, want) <= K3_TOL


def test_ring_lm_on_card_matches_local(card):
    """f32: the ring model (K3 every hop) against the local model (K2) on
    the same weights, logits and held-out loss."""
    from keystone_tpu_torch.evaluation import evaluate_perplexity
    from keystone_tpu_torch.models.lm import TransformerLM, synthetic_corpus
    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.parallel import create_mesh

    local = TransformerLM.create(vocab=97, max_seq=256, dim=64, depth=2, num_heads=4,
                                 pos_encoding="rope", device=card)
    ring = local.replace(seq_mode="ring", mesh=create_mesh(data=4, devices=[card] * 4))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 97, size=(2, 256))).to(card)
    before = fa.FLASH_ATTENTION_STEP.launches
    with torch.inference_mode():
        got, want = ring(toks), local(toks)
    assert fa.FLASH_ATTENTION_STEP.launches == before + 2 * 10  # causal: 10 live hops
    assert _rel(got, want) <= 1e-4
    held = synthetic_corpus(4 * 257, 97, seed=2)
    r = evaluate_perplexity(ring, held, seq=256, batch=2, logit_chunk=64)
    w = evaluate_perplexity(local, held, seq=256, batch=2)
    assert math.isfinite(r["loss"]) and r["loss"] == pytest.approx(w["loss"], rel=1e-5)


# --- training: K2 and K3 under autograd ---------------------------------------


def _vjp(fn, qkv, g):
    xs = [x.detach().clone().requires_grad_(True) for x in qkv]
    out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["dense", "blockwise"])
def test_k2_trainable_grads_match_plain_path(card, monkeypatch, dtype, route):
    """``flash_attention_trainable`` (K2 forward, K2's lse on the blockwise
    route) against dense attention under autograd, causal, S = 400 (the
    128-key backward blocks end ragged). f32: within 1e-4 of max|grad|.
    bf16: the dense route's backward is the plain path's own bf16
    recompute, so its gradients are the plain path's bit for bit; the
    blockwise route computes in f32 from K2's bf16 output and is held to
    the f32 truth on the same bf16 inputs at 2e-2 of max|grad| (the bf16
    output's rounding enters through Σ g·out)."""
    from keystone_tpu_torch.ops import attention
    from keystone_tpu_torch.ops import flash_attention as fa

    if route == "blockwise":
        monkeypatch.setenv("KST_FLASH_DENSE_BWD_MAX", "0")
        monkeypatch.setenv("KST_FLASH_BWD_BLOCK", "128")
    qkv = _qkv(card, 21, 2, 4, 400, 400, 64, dtype)
    g = torch.randn(qkv[0].shape, generator=torch.Generator(device=card).manual_seed(22),
                    device=card).to(dtype)
    before = fa.FLASH_ATTENTION.launches
    out, grads = _vjp(lambda *a: fa.flash_attention_trainable(*a, True), qkv, g)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION.launches == before + 1
    plain_out, plain = _vjp(lambda *a: attention.dense_attention(*a, causal=True), qkv, g)
    assert fa.FLASH_ATTENTION.launches == before + 1
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    if dtype == torch.float32:
        assert _rel(out, plain_out) <= 1e-5
        for a, b in zip(grads, plain):
            assert _rel(a, b) <= 1e-4
    elif route == "dense":
        assert _rel(out, plain_out) <= K2_BF16_TOL
        for a, b in zip(grads, plain):
            assert torch.equal(a, b)
    else:
        _, truth = _vjp(lambda *a: attention.dense_attention(*a, causal=True),
                        [x.float() for x in qkv], g.float())
        for a, b in zip(grads, truth):
            assert a.dtype == dtype and _rel(a, b) <= 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_ring_trainable_grads_through_k3_match_plain_ring(card, causal):
    """The trainable ring on one card named four times: K3 every live hop
    forward, the ring backward; against the plain ring's forward with the
    same backward, and against dense attention, f32, within 1e-4 of
    max|grad|."""
    from keystone_tpu_torch.ops import attention
    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=4, devices=[card] * 4)
    qkv = _qkv(card, 23, 1, 4, 1024, 1024, 64, torch.float32)
    g = torch.randn(qkv[0].shape, generator=torch.Generator(device=card).manual_seed(24),
                    device=card)
    before = fa.FLASH_ATTENTION_STEP.launches
    _, grads = _vjp(lambda *a: attention.ring_attention(*a, mesh, causal=causal,
                                                        trainable=True), qkv, g)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION_STEP.launches == before + (10 if causal else 16)
    _, plain = _vjp(lambda *a: attention.ring_attention(*a, mesh, causal=causal, use_flash=False,
                                                        trainable=True), qkv, g)
    _, dense = _vjp(lambda *a: attention.dense_attention(*a, causal=causal), qkv, g)
    for a, b, c in zip(grads, plain, dense):
        assert _rel(a, b) <= 1e-4 and _rel(a, c) <= 1e-4


@pytest.mark.parametrize("shape", [(8, 16, 2048, 64), (1, 8, 16384, 64)],
                         ids=["flagship_train", "long_context"])
def test_k2_with_lse_at_the_training_shapes(card, shape):
    """K2 bf16 causal with the lse at the train steps' shapes, against its
    plain version: the output within 8e-3 of max|plain|, the lse within
    1e-5."""
    from keystone_tpu_torch.ops import flash_attention as fa

    b, h, s, d = shape
    q, k, v = _qkv(card, 25, b, h, s, s, d, torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    assert _rel(out, ref) <= K2_BF16_TOL
    assert float((lse - ref_lse).abs().max()) <= 1e-5


def test_lm_train_step_on_card_matches_plain_path(card, monkeypatch):
    """f32, a small model: every leaf's gradient through K2 (forward) and
    the ported backward against dense attention under autograd, within
    1e-4 of max|grad|; K2 launches once a layer, twice under remat; a
    few optimizer steps lower the loss."""
    from keystone_tpu_torch.models.lm import TransformerLM, next_token_loss, synthetic_corpus
    from keystone_tpu_torch.models.lm.train import make_optimizer, make_train_step
    from keystone_tpu_torch.ops import flash_attention as fa

    model = TransformerLM.create(vocab=97, max_seq=256, dim=128, depth=2, num_heads=2,
                                 device=card)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 97, size=(2, 257))).to(card)

    def grads(m):
        params = m.leaves()
        for p in params:
            p.requires_grad_(True)
        return torch.autograd.grad(next_token_loss(m, toks), params)

    for policy in (None, "full", "dots"):
        m = model if policy is None else model.replace(remat=True, remat_policy=policy)
        before = fa.FLASH_ATTENTION.launches
        got = grads(m)
        torch.cuda.synchronize()
        assert fa.FLASH_ATTENTION.launches == before + (2 if policy is None else 4)
        monkeypatch.setenv("KST_LOCAL_ATTN", "dense")
        want = grads(m)
        monkeypatch.delenv("KST_LOCAL_ATTN")
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-4
    corpus = synthetic_corpus(5000, 97, seed=1)
    opt = make_optimizer(3e-3)
    state = opt.init(model.leaves())
    step = make_train_step(opt)
    losses = []
    for i in range(6):
        batch = np.stack([corpus[j : j + 129] for j in range(i * 300, i * 300 + 4 * 70, 70)])
        _, state, loss = step(model, state, torch.from_numpy(batch).to(card))
        losses.append(float(loss))
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# serving on CUDA graphs: the decode pool's step and prefill graphs, K2 and
# K4 under replay, the exported apply's bucket graphs

SERVE_LM = dict(vocab=512, max_seq=128, dim=128, depth=2, num_heads=4)


def _serve_loop(card, slots=4, **kw):
    from keystone_tpu_torch.models.lm import TransformerLM, quantize_for_decode
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    model = TransformerLM.create(**SERVE_LM, device=card,
                                 generator=torch.Generator(device=card).manual_seed(0))
    qmodel = quantize_for_decode(model).replace(int8_kernel="kernel")
    return DecodeLoop(qmodel, slots=slots, s_max=SERVE_LM["max_seq"], max_new=100, **kw)


def _fill_pool(loop, lens=(5, 17, 33, 9)):
    rng = np.random.default_rng(2)
    for n in lens:
        loop.submit(rng.integers(0, SERVE_LM["vocab"], size=n), max_new=100)
    loop._admit()


def test_graphed_pool_step_matches_eager(card):
    """From the same pool state, one replay of the step graph against one
    eager step: f32 logits within 1e-5 of max|logit|, the same tokens;
    then 64 greedy steps each way give the same tokens."""
    from keystone_tpu_torch.ops.int8_matmul import INT8_MATMUL

    loop = _serve_loop(card)
    before = INT8_MATMUL.launches
    loop.warm()
    captured = INT8_MATMUL.launches - before
    assert loop.graphed and captured > 0
    _fill_pool(loop)
    cache = loop.cache
    state = [t.clone() for t in (cache.k, cache.v, cache.pos)]

    def restore():
        for buf, saved in zip((cache.k, cache.v, cache.pos), state):
            buf.copy_(saved)

    tok0 = torch.from_numpy(loop._tok.copy()).to(card)
    g = loop._step_graph
    with torch.inference_mode():
        g.inputs[0].copy_(tok0)
        g.graph.replay()
        g_tok, g_logits = (t.clone() for t in g.outputs)
        restore()
        e_tok, e_logits = loop._pool_step(tok0)
        torch.cuda.synchronize()
        err = float((g_logits - e_logits).abs().max() / e_logits.abs().max())
        assert err <= 1e-5, err
        assert torch.equal(g_tok, e_tok)
        launches = INT8_MATMUL.launches

        def run(graphed):
            restore()
            tok, out = tok0.clone(), []
            for _ in range(64):
                if graphed:
                    g.inputs[0].copy_(tok)
                    g.graph.replay()
                    tok = g.outputs[0].clone()
                else:
                    tok = loop._pool_step(tok)[0]
                out.append(tok)
            return torch.stack(out)

        graphed = run(True)
        assert INT8_MATMUL.launches == launches  # a replay is no wrapper call
        eager = run(False)
    assert torch.equal(graphed, eager)


def test_graphed_prefill_buckets_match_eager(card):
    loop = _serve_loop(card)
    loop.warm()
    assert set(loop._prefill_graphs) == set(loop.prefill_buckets)
    rng = np.random.default_rng(4)
    for width in loop.prefill_buckets:
        n = max(1, width - 3)
        padded = np.zeros((1, width), np.int64)
        padded[0, :n] = rng.integers(0, SERVE_LM["vocab"], size=n)
        with torch.inference_mode():
            tok, one = loop._run_prefill(padded, n)
            g_k, g_v, g_pos = one.k.clone(), one.v.clone(), one.pos.clone()
            e_tok, e_one = loop._prefill(
                torch.from_numpy(padded).to(card), torch.tensor([n], device=card))
        assert tok == int(e_tok[0]), width
        assert int(g_pos[0]) == n == int(e_one.pos[0])
        for got, want in ((g_k, e_one.k), (g_v, e_one.v)):
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-5, (width, err)


def test_sampled_graph_replays_draw_fresh_numbers(card):
    loop = _serve_loop(card, temperature=1.0, top_k=50, top_p=0.9, seed=5)
    loop.warm()
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, SERVE_LM["vocab"], size=12)
    outs = loop.run([prompt, prompt, prompt], max_new=24)
    assert all(len(o) == 24 and ((o >= 0) & (o < SERVE_LM["vocab"])).all() for o in outs)
    # the same prompt in three slots: replays that reused one draw would
    # give three equal sequences
    assert len({tuple(o) for o in outs}) > 1


@pytest.mark.parametrize("dtype,shape,causal", [
    (torch.bfloat16, (1, 16, 128, 64), True),
    (torch.float32, (1, 16, 128, 64), True),
    (torch.float32, (512, 4, 16, 32), False),  # ViT's call: the short-key kernel
    (torch.float32, (8, 16, 2048, 64), True),  # the f32 legs' call: the tiled kernel
])
def test_k2_graph_replays_give_the_eager_bits(card, dtype, shape, causal):
    from keystone_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=card).manual_seed(9)
    q, k, v = (torch.randn(shape, device=card, generator=gen).to(dtype) for _ in range(3))
    eager = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, causal=causal)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_exported_apply_replays_the_eager_classes(card):
    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.serve import server
    from keystone_tpu_torch.serve.export import export_pipeline

    pipe, sample = server._fit_mnist_demo(512, num_ffts=2, device=card)
    exported = export_pipeline(pipe, sample, buckets=(1, 8, 32), device=card)
    assert set(exported._graphs) == {1, 8, 32}
    fallback = metrics.get_registry().snapshot().get("serve_aot_fallback", 0)
    rng = np.random.default_rng(8)
    for n in (1, 5, 8, 32, 45):
        rows = rng.normal(size=(n, 784)).astype(np.float32)
        got = exported(rows)
        want = pipe(torch.from_numpy(rows).to(card))
        assert got.device.type == "cuda" and torch.equal(got, want), n
    assert metrics.get_registry().snapshot().get("serve_aot_fallback", 0) == fallback


def test_a_capture_that_syncs_raises_and_nothing_falls_back(card, monkeypatch):
    """A host read inside the captured step fails the capture: warm()
    raises, and so does a step, which captures first: no eager step runs
    in its place."""
    from keystone_tpu_torch.serve import decode_loop

    real = decode_loop.decode_step

    def syncing(model, token, cache):
        int(token.sum())  # a host read: not capturable
        return real(model, token, cache)

    loop = _serve_loop(card, slots=2)
    monkeypatch.setattr(decode_loop, "decode_step", syncing)
    with pytest.raises(RuntimeError):
        loop.warm()
    assert not loop.graphed
    loop.submit([1, 2, 3], max_new=4)
    with pytest.raises(RuntimeError):
        loop.step()
    assert not loop.graphed and loop.tokens_out == 0
    torch.cuda.synchronize()


# --- TIMIT: K1 at D = 32,768, the streamed fit, the scaler and the planner


def test_k1_matches_plain_at_timit_width(card):
    """K1 at the TIMIT fit's chunk shape (8,192 × 32,768): the (D, D) f32
    output is 4.3 GB, its byte offsets past 2³¹; bit for bit."""
    gen = torch.Generator(device=card).manual_seed(32768)
    q = torch.randint(-127, 128, (8192, 32768), dtype=torch.int8, device=card, generator=gen)
    got = gram.int8_gram(q)
    want = gram.int8_gram_plain(q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[-256:, :256], got[:256, -256:].T)


def _timit_rows(n=600):
    from keystone_tpu_torch.models import timit_pipeline as tt

    return tt._load(tt.TimitConfig(synthetic=n), "train")


def test_scaler_and_cosine_features_on_card_match_cpu(card):
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures, StandardScaler

    rows = torch.from_numpy(_timit_rows().data)
    for dist in ("gaussian", "cauchy"):
        cpu_f = CosineRandomFeatures.create(440, 256, torch.Generator().manual_seed(1), 0.05555, dist, device="cpu")
        card_f = CosineRandomFeatures.create(440, 256, torch.Generator().manual_seed(1), 0.05555, dist, device=card)
        assert torch.equal(card_f.w.cpu(), cpu_f.w) and torch.equal(card_f.b.cpu(), cpu_f.b)
        cpu_raw, card_raw = cpu_f(rows), card_f(rows.to(card))
        tol = 8 * torch.finfo(torch.float32).eps * float((rows.abs() @ cpu_f.w.abs().T + cpu_f.b.abs()).max())
        assert float((card_raw.cpu() - cpu_raw).abs().max()) <= tol
        # the scaler on the same features: a nearly constant column (a tiny
        # Cauchy w) has a std of a few 1e-3, which the features' own
        # difference above would move by percents
        for n_valid in (None, 550):
            cpu_s = StandardScaler().fit(cpu_raw, n_valid=n_valid)
            card_s = StandardScaler().fit(cpu_raw.to(card), n_valid=n_valid)
            torch.testing.assert_close(card_s.mean.cpu(), cpu_s.mean, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(card_s.std.cpu(), cpu_s.std, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["fp32", "int8"])
def test_timit_streamed_fit_on_card_matches_cpu(card, monkeypatch, op):
    """The streamed TIMIT fit at a small width (2 banks of 128) on the card
    against the same fit on the CPU: the weights within 5e-4 relative and
    1e-5 absolute in fp32; in int8 the card's and the CPU's features round
    a few codes apart, so the predictions are held instead."""
    from keystone_tpu_torch.models import timit_pipeline as tt

    monkeypatch.setenv("KEYSTONE_PLAN", "1")
    monkeypatch.setenv("KEYSTONE_GRAM_OP", op)
    argv = ["--synthetic", "2000", "--num-cosines", "2", "--cosine-features", "128"]
    before = gram.INT8_GRAM.launches
    on_card = tt.main(argv, device=card)
    launches = gram.INT8_GRAM.launches - before
    on_cpu = tt.main(argv, device="cpu")
    assert gram.INT8_GRAM.launches - before == launches == (1 if op == "int8" else 0)
    fit_op = next(d for d in on_card["fit_decisions"] if d["action"] == "fit_operator")
    assert fit_op["op"] == op
    agree = (on_card["test_predictions"] == on_cpu["test_predictions"]).mean()
    assert agree >= 0.99 and abs(on_card["test_error"] - on_cpu["test_error"]) <= 0.01
    if op == "fp32":
        from keystone_tpu_torch import plan
        from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
        from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
        from keystone_tpu_torch.ops.util import ClassLabelIndicators

        train = _timit_rows(2000)
        conf = tt.TimitConfig(synthetic=2000, num_cosines=2, cosine_features=128)
        xs = {}
        for dev in (card, torch.device("cpu")):
            x = torch.from_numpy(train.data).to(dev)
            feats = tt.make_featurizers(conf, dev)
            scalers, _ = tt.fit_scalers(feats, x, len(train), False)
            bank = tt.ScaledCosineBank(chains=tuple(f >> s for f, s in zip(feats, scalers)))
            fitted = plan.fit_streaming(
                ChainedLabelEstimator(prefix=bank, est=BlockLeastSquaresEstimator(block_size=128, num_iter=2)),
                x, ClassLabelIndicators(num_classes=147)(train.labels).to(dev),
                n_valid=len(train), device=dev, chunk_size=512)
            xs[dev.type] = torch.cat([w.cpu() for w in fitted[-1].xs])
        np.testing.assert_allclose(xs["cuda"].numpy(), xs["cpu"].numpy(), rtol=5e-4, atol=1e-5)


def test_planner_picks_int8_by_cost_model_on_an_h100(card, monkeypatch):
    """A TIMIT-shaped bank (8 cosine banks of 512 at γ 0.05555) clears the
    quantization gate, and an H100's int8 rate wins: ``auto`` picks int8."""
    if "h100" not in torch.cuda.get_device_name(card).lower():
        pytest.skip("the cost model's int8 advantage is the H100's")
    from keystone_tpu_torch import plan
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
    from keystone_tpu_torch.models import timit_pipeline as tt
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicators

    monkeypatch.delenv("KEYSTONE_GRAM_OP", raising=False)
    train = _timit_rows(1024)
    conf = tt.TimitConfig(synthetic=1024, num_cosines=8, cosine_features=512)
    x = torch.from_numpy(train.data).to(card)
    feats = tt.make_featurizers(conf, card)
    scalers, _ = tt.fit_scalers(feats, x, len(train), False)
    bank = tt.ScaledCosineBank(chains=tuple(f >> s for f, s in zip(feats, scalers)))
    p = plan.plan_fit(
        ChainedLabelEstimator(prefix=bank, est=BlockLeastSquaresEstimator(block_size=512)),
        x, ClassLabelIndicators(num_classes=147)(train.labels), device=card)
    op = p.decision("fit_operator")
    assert (op["op"], op["reason"]) == ("int8", "cost_model"), op
    assert op["quantization_error"] <= op["threshold"] and op["int8_speedup"] == 2.0


# --- the MoE LM and ViT (K2 f32 and bf16, K4 beside float experts) ----------

MOE_LM = dict(vocab=97, max_seq=64, dim=64, depth=2, num_heads=4, moe_every=2, num_experts=4)


def _moe_pair(card, compute_dtype="float32"):
    """A tiny MoE LM on the CPU and the same leaves on the card (its routers
    scaled 25× so that tokens route with clear margins)."""
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.models.lm import TransformerLM

    cpu = TransformerLM.create(**MOE_LM, compute_dtype=compute_dtype, device="cpu",
                               generator=torch.Generator().manual_seed(11))
    for m in cpu.experts:
        m.w_router.data.mul_(25.0)

    def leaf(t):
        return t.detach().numpy()

    leaves = {
        "embed": leaf(cpu.embed),
        "pos_embed": leaf(cpu.pos_embed),
        "blocks": [dict(zip(("wq", "wk", "wv", "wo", "w1", "w2"), map(leaf, b.leaves())))
                   for b in cpu.blocks],
        "moe_layers": [None if m is None else dict(zip(("w_router", "w1", "w2"),
                                                       map(leaf, m.leaves())))
                       for m in cpu.moe_layers],
    }
    dev = convert.transformer_lm(leaves, num_heads=MOE_LM["num_heads"],
                                 compute_dtype=compute_dtype, device=card)
    return cpu, dev


def _min_route_margin(layers, fn):
    """The smallest top-1/top-2 and top-2/top-3 router-logit gap over every
    token that reached one of the MoE ``layers`` while ``fn`` ran."""
    gaps = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: gaps.append(
            (args[0].float().reshape(-1, args[0].shape[-1]) @ mod.w_router.float())
            .sort(dim=-1, descending=True).values.diff(dim=-1)[:, :2].abs().min().item()))
        for m in layers]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return min(gaps)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_moe_layer_on_card_matches_cpu(card, dtype, tol):
    from keystone_tpu_torch.ops.moe import MoELayer

    layer = MoELayer.create(64, 256, 8, group_size=64, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    layer.w_router.data.mul_(25.0)
    dev = MoELayer(*(p.detach().to(card) for p in layer.leaves()), group_size=64)
    x = torch.randn((4, 40, 64), generator=torch.Generator().manual_seed(4))
    assert _min_route_margin([layer], lambda: layer(x)) > 1e-4
    want, want_aux = layer(x.to(dtype))
    got, aux = dev(x.to(dtype).to(card))
    assert got.dtype == dtype and got.is_cuda
    err = float((got.float().cpu() - want.float()).abs().max() / want.float().abs().max())
    assert err <= tol, err
    assert abs(float(aux) - float(want_aux)) <= 1e-4 * float(want_aux)


def test_moe_lm_on_card_matches_cpu(card):
    """f32 prefill and decode: K2 and K4 on the card (the experts float),
    dense attention and the plain int8 matmul on the CPU; logits within
    1e-4 of max|logit| where every token routes with a clear margin."""
    from keystone_tpu_torch.models.lm import decode, quantize_for_decode
    from keystone_tpu_torch.ops import flash_attention, int8_matmul

    cpu, dev = _moe_pair(card)
    cpu, dev = quantize_for_decode(cpu), quantize_for_decode(dev).replace(int8_kernel="kernel")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 97, size=(3, 24)))

    def run(m, device):
        logits, cache = decode.prefill(m, toks[:, :12].to(device), 24)
        out = [logits]
        for j in range(11):
            logits, cache = decode.decode_step(m, toks[:, 12 + j].to(device), cache)
            out.append(logits)
        return torch.stack(out)

    assert _min_route_margin(cpu.experts, lambda: run(cpu, "cpu")) > 1e-4
    want = run(cpu, "cpu")
    k2, k4 = flash_attention.FLASH_ATTENTION.launches, int8_matmul.INT8_MATMUL.launches
    got = run(dev, card)
    torch.cuda.synchronize()
    assert flash_attention.FLASH_ATTENTION.launches == k2 + MOE_LM["depth"]
    # 6 block matrices a dense block, 4 a MoE block (its FFN is the experts')
    assert int8_matmul.INT8_MATMUL.launches == k4 + (6 + 4) * 12
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err


def test_moe_graphed_pool_step_matches_eager(card):
    """The MoE pool's step is captured and replayed: 64 greedy steps from
    one state give the eager tokens, the idle slots routing too."""
    from keystone_tpu_torch.models.lm import quantize_for_decode
    from keystone_tpu_torch.serve.decode_loop import DecodeLoop

    _, dev = _moe_pair(card, "bfloat16")
    loop = DecodeLoop(quantize_for_decode(dev).replace(int8_kernel="kernel"), slots=4,
                      s_max=64, max_new=100)
    loop.warm()
    assert loop.graphed and set(loop._prefill_graphs) == set(loop.prefill_buckets)
    rng = np.random.default_rng(2)
    for n in (5, 17, 9):  # 3 of 4 slots busy
        loop.submit(rng.integers(0, 97, size=n), max_new=100)
    loop._admit()
    cache = loop.cache
    state = [t.clone() for t in (cache.k, cache.v, cache.pos)]
    tok0 = torch.from_numpy(loop._tok.copy()).to(card)
    g = loop._step_graph

    def run(graphed):
        for buf, saved in zip((cache.k, cache.v, cache.pos), state):
            buf.copy_(saved)
        tok, out = tok0.clone(), []
        for _ in range(64):
            if graphed:
                g.inputs[0].copy_(tok)
                g.graph.replay()
                tok = g.outputs[0].clone()
            else:
                tok = loop._pool_step(tok)[0]
            out.append(tok)
        return torch.stack(out)

    with torch.inference_mode():
        assert torch.equal(run(True), run(False))


def test_moe_train_grads_on_card_match_cpu(card):
    """f32 leaf gradients of next_token_loss (aux included) through K2 and
    the ported backward on the card against dense attention on the CPU."""
    from keystone_tpu_torch.models.lm import next_token_loss

    cpu, dev = _moe_pair(card)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 97, size=(2, 33)))
    assert _min_route_margin(cpu.experts, lambda: cpu(toks[:, :-1])) > 1e-4

    def grads(m, device):
        params = m.leaves()
        for p in params:
            p.requires_grad_(True)
        loss = next_token_loss(m, toks.to(device))
        return loss, torch.autograd.grad(loss, params, allow_unused=True)

    want_loss, want = grads(cpu, "cpu")
    got_loss, got = grads(dev, card)
    assert abs(float(got_loss.detach()) - float(want_loss.detach())) <= 1e-5 * float(want_loss.detach())
    for g, w in zip(got, want):
        if w is None or w.numel() == 0:
            continue
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-12


def test_vit_on_card_matches_cpu(card):
    """ViT's f32 attention through K2 on the card against dense attention
    on the CPU: features within 1e-4 of max|f|, K2 once a block."""
    from keystone_tpu_torch.ops import flash_attention
    from keystone_tpu_torch.ops.vit import ViTBlock, ViTFeaturizer

    cpu = ViTFeaturizer.create(device="cpu", generator=torch.Generator().manual_seed(0))
    dev = ViTFeaturizer(
        patch_embed=cpu.patch_embed.to(card), pos_embed=cpu.pos_embed.to(card),
        blocks=tuple(ViTBlock(*(getattr(b, n).to(card) for n in ("wq", "wk", "wv", "wo", "w1",
                                                                  "w2")), num_heads=b.num_heads)
                     for b in cpu.blocks))
    x = torch.rand((512, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    before = flash_attention.FLASH_ATTENTION.launches
    got = dev(x.to(card))
    torch.cuda.synchronize()
    assert flash_attention.FLASH_ATTENTION.launches == before + len(cpu.blocks)
    want = cpu(x)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err


def test_vit_ridge_and_linear_pixels_on_card(card):
    from keystone_tpu_torch.models import cifar_linear_pixels, vit_ridge
    from keystone_tpu_torch.ops import flash_attention

    before = flash_attention.FLASH_ATTENTION.launches
    res = vit_ridge.main(["--synthetic", "2000", "--chunk-size", "512"], device="cuda")
    # ceil(2000/512) + 1 test chunk (400 rows), 4 blocks each
    assert flash_attention.FLASH_ATTENTION.launches == before + (4 + 1) * 4
    assert res["n_train"] == 2000 and res["test_error"] <= 0.05
    res = cifar_linear_pixels.main(["--synthetic", "2000"], device="cuda")
    assert res["n_test"] == 400 and res["test_error"] <= 0.05


def _conv_case(seed, n=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, size=(n, 32, 32, 3)).astype(np.float32)
    filters = rng.normal(size=(64, 108)).astype(np.float32)
    means = rng.normal(size=(108,)).astype(np.float32)
    return x, filters, means


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_convolver_on_card_matches_cpu(card, impl):
    """The cuDNN convolution with its box sums (TF32 off: the entry
    points' ``resolve_device`` and the node's own scope) against the CPU,
    within 1e-5 of max|out|; the fused node too."""
    from keystone_tpu_torch.ops import images

    x, filters, means = _conv_case(0)
    node = images.Convolver(filters=torch.from_numpy(filters),
                            whitener_means=torch.from_numpy(means), impl=impl)
    want = node(torch.from_numpy(x))
    dev = images.Convolver(filters=node.filters.to(card), whitener_means=node.whitener_means.to(card),
                           impl=impl)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the node must scope it off itself
    try:
        got = dev(torch.from_numpy(x).to(card)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    fused = images.FusedConvRectifyPool(filters=dev.filters, whitener_means=dev.whitener_means,
                                        alpha=0.25)
    cpu_fused = images.FusedConvRectifyPool(filters=node.filters, whitener_means=node.whitener_means,
                                            alpha=0.25)
    got, want = fused(torch.from_numpy(x).to(card)).cpu(), cpu_fused(torch.from_numpy(x))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_conv2d_separable_on_card_is_full_f32(card):
    """Both passes in full f32 even with cuDNN's TF32 switched on around
    the call: within 1e-6 of max|out| of the CPU (TF32 would read about
    1e-3)."""
    from keystone_tpu_torch.utils.images import conv2d_separable

    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, size=(8, 64, 64, 3)).astype(np.float32)
    kx, ky = rng.normal(size=9).astype(np.float32), rng.normal(size=6).astype(np.float32)
    want = conv2d_separable(torch.from_numpy(x), kx, ky)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = conv2d_separable(torch.from_numpy(x).to(card), kx, ky).cpu()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_zca_on_card_matches_cpu(card):
    """The whitener from cuSOLVER's SVD of a (100,000 × 108) patch sample
    against the CPU's LAPACK, within 1e-5 of max|W|, and against float64
    within 2e-6 (the CPU's f32 reads 8e-7; torch's default Jacobi driver
    on the card read 2.2e-5); PCA of a wide sample too."""
    from keystone_tpu_torch.ops import images, linalg

    x, _, _ = _conv_case(2, n=140)
    flat = images.ImageVectorizer()(images.Windower()(torch.from_numpy(x)))[:100_000]
    base = images.normalize_patch_rows(flat, 10.0)
    want = linalg.ZCAWhitenerEstimator().fit(base)
    exact = linalg.ZCAWhitenerEstimator().fit(base.double())
    got = linalg.ZCAWhitenerEstimator().fit(base.to(card))
    scale = float(want.whitener.abs().max())
    assert float((got.whitener.cpu() - want.whitener).abs().max()) <= 1e-5 * scale
    assert float((got.whitener.cpu().double() - exact.whitener).abs().max()) <= 2e-6 * scale
    assert float((got.means.cpu() - want.means).abs().max()) <= 1e-5 * float(want.means.abs().max())
    # a wide sample (through gesvd's transpose) whose singular values lie
    # 17 % apart, so its leading vectors are defined to about 1e-6 in f32
    rng = np.random.default_rng(5)
    u = np.linalg.qr(rng.normal(size=(30, 30)))[0]
    v = np.linalg.qr(rng.normal(size=(50, 30)))[0]
    wide = torch.from_numpy(((u * np.geomspace(100.0, 1.0, 30)) @ v.T).astype(np.float32))
    pca = linalg.compute_pca(wide.to(card), 10).cpu()
    want_pca = linalg.compute_pca(wide, 10)
    assert float((pca - want_pca).abs().max()) <= 1e-5 * float(want_pca.abs().max())


def test_naive_bayes_on_card_matches_cpu(card):
    from keystone_tpu_torch.ops.naive_bayes import NaiveBayesEstimator

    rng = np.random.default_rng(3)
    x = (rng.random((4000, 600)) < 0.05).astype(np.float32)
    labels = rng.integers(0, 20, size=4000)
    want = NaiveBayesEstimator(num_classes=20).fit(torch.from_numpy(x), labels, n_valid=3900)
    got = NaiveBayesEstimator(num_classes=20).fit(torch.from_numpy(x).to(card), labels,
                                                  n_valid=3900)
    for g, w in ((got.log_pi, want.log_pi), (got.log_theta, want.log_theta)):
        assert float((g.cpu() - w).abs().max()) <= 1e-6 * float(w.abs().max())
    assert torch.equal(got(torch.from_numpy(x).to(card)).argmax(1).cpu(),
                       want(torch.from_numpy(x)).argmax(1))


def test_conv_and_text_workloads_on_card(card):
    from keystone_tpu_torch.models import (cifar_random, cifar_random_patch, newsgroups_pipeline)

    res = cifar_random_patch.main(["--synthetic", "2000", "--num-filters", "32"], device="cuda")
    assert res["n_test"] == 400 and res["test_error"] <= 0.05 and res["num_features"] == 256
    res = cifar_random.main(["--synthetic", "2000", "--num-filters", "32"], device="cuda")
    assert res["test_error"] <= 0.05
    res = newsgroups_pipeline.main(["--synthetic", "2000", "--corenlp"], device="cuda")
    assert res["device"].startswith("cuda") and res["test_error"] <= 0.05


def _quantized_agree(got, want, min_equal=0.999):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1.0
    assert float((got == want).float().mean()) >= min_equal


@pytest.mark.parametrize("hw,scales", [(64, 3), (256, 5)])
def test_sift_on_card_matches_cpu(card, hw, scales):
    """Descriptors on the card against the CPU's on the same images: the
    float stages within 1e-5 of max, the quantized output within ±1
    everywhere and ≥ 99.9 % equal (``floor(512·v)`` flips at rounding
    edges)."""
    from keystone_tpu_torch.ops import sift

    x = torch.from_numpy(np.random.default_rng(hw).uniform(0, 1, (3, hw, hw)).astype(np.float32))
    planes = sift._orientation_planes(x)
    planes_card = sift._orientation_planes(x.to(card)).cpu()
    assert float((planes_card - planes).abs().max()) <= 1e-5 * float(planes.abs().max())
    desc = sift._scale_descriptors(x, 6, 3, 2)
    desc_card = sift._scale_descriptors(x.to(card), 6, 3, 2).cpu()
    assert float((desc_card - desc).abs().max()) <= 1e-5 * float(desc.abs().max())
    ext = sift.SIFTExtractor(num_scales=scales)
    _quantized_agree(ext(x.to(card)).cpu(), ext(x))


@pytest.mark.parametrize("name", ["synthetic", "voc000012"])
def test_sift_goldens_on_card(card, name):
    import pathlib

    from keystone_tpu_torch.ops import sift

    goldens = pathlib.Path(__file__).parent / "goldens"
    golden = np.loadtxt(goldens / f"sift_{name}.csv", delimiter=",")
    img = np.loadtxt(goldens / f"sift_{name}_input.csv", delimiter=",").astype(np.float32)
    header = (goldens / f"sift_{name}.csv").read_text().splitlines()[0]
    p = dict(kv.split("=") for kv in header.lstrip("# ").split() if "=" in kv)
    ext = sift.SIFTExtractor(step=int(p["step"]), bin_size=int(p["bin_size"]),
                             num_scales=int(p["num_scales"]), scale_step=int(p["scale_step"]))
    out = ext(torch.from_numpy(img)[None].to(card))[0].T.cpu().numpy()
    assert out.shape == golden.shape
    assert (np.abs(out - golden) <= 1.0).mean() >= 0.995


def test_gmm_em_and_fisher_on_card_match_cpu(card):
    """EM from one start for 10 iterations, with cuBLAS's TF32 switched on
    around the call (the E and M products must scope it off): means
    within 1e-4 of max|mean| of the CPU's; the Fisher vectors of the
    fitted model within 1e-5 of max|f|."""
    from keystone_tpu_torch.ops import gmm

    rng = np.random.default_rng(2)
    centers = rng.normal(scale=3.0, size=(12, 16))
    x = torch.from_numpy((centers[rng.integers(0, 12, 20000)]
                          + rng.normal(size=(20000, 16))).astype(np.float32))
    init = gmm.gmm_init(x, 8, seed=1, var_floor=gmm.VAR_FLOOR)
    want = gmm.gmm_em(x, *init, 10)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = [a.cpu() for a in gmm.gmm_em(x.to(card), *(a.to(card) for a in init), 10)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    model = gmm.GaussianMixtureModel(*want)
    desc = torch.from_numpy(rng.normal(size=(4, 16, 300)).astype(np.float32))
    fv = gmm.FisherVector(gmm=model)(desc)
    fv_card = gmm.FisherVector(gmm=gmm.GaussianMixtureModel(*(a.to(card) for a in want)))(
        desc.to(card)).cpu()
    assert float((fv_card - fv).abs().max()) <= 1e-5 * float(fv.abs().max())


def test_voc_on_card_matches_cpu(card, tmp_path):
    """``voc_sift_fisher.run`` on the card and on the CPU from the same PCA
    and GMM artifacts (the CPU run writes them): mAPs within 1e-4."""
    from keystone_tpu_torch.models import voc_sift_fisher as voc

    files = dict(pca_file=str(tmp_path / "pca.csv"), gmm_mean_file=str(tmp_path / "m.csv"),
                 gmm_var_file=str(tmp_path / "v.csv"), gmm_wt_file=str(tmp_path / "w.csv"))
    conf = voc.VOCConfig(synthetic=24, image_size=64, sift_scales=2, desc_dim=16, vocab_size=4,
                         num_pca_samples=2000, num_gmm_samples=1000, lam=5.0, block_size=512,
                         chunk_size=8, **files)
    cpu = voc.run(conf, device="cpu")
    dev = voc.run(conf, device="cuda")
    assert dev["device"].startswith("cuda") and cpu["train_map"] > 0.3
    assert abs(dev["train_map"] - cpu["train_map"]) <= 1e-4
    assert abs(dev["test_map"] - cpu["test_map"]) <= 1e-4


def _weighted_data(seed, n, d, c, dominant=None):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, c, size=n)
    if dominant is not None:
        cls[: int(dominant * n)] = 0
        rng.shuffle(cls)
    a = ((rng.normal(size=(c, d)) * 2)[cls] + rng.normal(size=(n, d))).astype(np.float32)
    y = -np.ones((n, c), np.float32)
    y[np.arange(n), cls] = 1.0
    return torch.from_numpy(a), torch.from_numpy(y)


@pytest.mark.parametrize(
    "n,d,c,block,iters,dominant,solve",
    [
        (400, 160, 8, 160, 3, None, "woodbury"),
        (2000, 256, 6, 128, 1, None, "dense"),
        (2000, 256, 6, 128, 3, None, "dense_hoisted"),
        (300, 24, 4, 12, 2, 0.85, "dense_hoisted"),  # the masked layout
    ],
)
def test_weighted_fit_on_card_matches_cpu(card, n, d, c, block, iters, dominant, solve):
    """The weighted fit on the card against the CPU's on the same rows,
    with cuBLAS's TF32 switched on around the call (the solver's scope
    must hold full f32): weights and intercept within 1e-4 of max|W|."""
    from keystone_tpu_torch.ops import weighted_linear as wl

    a, y = _weighted_data(n + d, n, d, c, dominant)
    est = wl.BlockWeightedLeastSquaresEstimator(block_size=block, num_iter=iters, lam=0.1,
                                                mixture_weight=0.25, class_chunk=4)
    assert {b["solve"] for b in wl.fit_path(est, y, d)["blocks"]} == {solve}
    want = est.fit(a, y)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = est.fit(a.to(card), y.to(card))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    x_w, x_g = torch.cat(want.xs), torch.cat(got.xs).cpu()
    scale = float(x_w.abs().max())
    assert float((x_g - x_w).abs().max()) <= 1e-4 * scale
    assert float((got.b.cpu() - want.b).abs().max()) <= 1e-4 * max(scale, float(want.b.abs().max()))


def test_weighted_fit_stats_on_card_match_cpu(card):
    from keystone_tpu_torch.ops import weighted_linear as wl

    a, y = _weighted_data(5, 900, 48, 5)
    est = wl.BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=2, lam=0.3)
    models = []
    for dev in ("cpu", card):
        state = est.fit_stats_init(48, 5, device=dev)
        for s in range(0, 900, 256):
            state = est.fit_stats_update(state, a[s : s + 256].to(dev), y[s : s + 256].to(dev))
        models.append(est.fit_stats_finalize(state))
    x_w, x_g = torch.cat(models[0].xs), torch.cat(models[1].xs).cpu()
    assert float((x_g - x_w).abs().max()) <= 1e-4 * float(x_w.abs().max())


def test_lcs_hog_daisy_on_card_match_cpu(card):
    """The descriptor stack's float outputs on the card within 1e-5 of
    max of the CPU's on the same images."""
    from keystone_tpu_torch.ops import daisy, hog, lcs

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0, 1, (3, 96, 80, 3)).astype(np.float32))
    for ext, inp in ((lcs.LCSExtractor(), x), (hog.HogExtractor(), x),
                     (daisy.DaisyExtractor(), x[..., :1])):
        want = ext(inp)
        got = ext(inp.to(card)).cpu()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), type(ext)


def test_imagenet_streaming_on_card_matches_cpu(card):
    """``featurize_stream`` on the card equals ``apply_in_chunks`` of the
    same featurizer there; the ImageNet run on the card gives the CPU's
    top-1 and top-5 errors at a tiny width (four far-apart synthetic
    classes: each run fits its own PCA and GMM)."""
    from keystone_tpu_torch.loaders import streaming
    from keystone_tpu_torch.models import imagenet_sift_lcs_fv as imnet

    conf = imnet.ImageNetConfig(synthetic=48, synthetic_classes=4, desc_dim=8, vocab_size=4,
                                num_pca_samples=2000, num_gmm_samples=1000, image_size=64,
                                chunk_size=8, stream_batch=16)
    _, _, _, lcs_fn = imnet._extractors(conf)
    batches = [b for b, _ in imnet.synthetic_source(conf, "train")()]
    got = streaming.featurize_stream(iter(batches), lcs_fn, chunk_size=8, device=card)
    want = torch.cat([apply_in_chunks(lcs_fn, b, 8, card) for b in batches]).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    cpu = imnet.run(conf, device="cpu")
    dev = imnet.run(conf, device="cuda")
    assert dev["device"].startswith("cuda")
    for key in ("train_top1_error", "test_top1_error", "test_top5_error"):
        assert dev[key] == cpu[key], key


def test_pca_of_a_tall_sample_on_card_matches_cpu(card):
    """Past one ``gesvd`` call's size (2²⁷ elements) the card's PCA takes
    a blockwise QR first: the projector onto its 8 leading directions
    within 1e-4 of max of the CPU's (LAPACK's SVD of the whole sample)."""
    from keystone_tpu_torch.ops import linalg

    rng = np.random.default_rng(6)
    n, d = (1 << 27) // 32 + 4099, 32
    scales = np.concatenate([np.linspace(6.0, 2.0, 8), np.full(d - 8, 0.5)]).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32) * scales)
    want = linalg.compute_pca(x, 8).double()
    got = linalg.compute_pca(x.to(card), 8).double().cpu()
    p_got, p_want = got @ got.T, want @ want.T
    assert float((p_got - p_want).abs().max()) <= 1e-4 * float(p_want.abs().max())


# --------------------------------------------------------------- state, online learning


def test_native_backends_take_cuda_tensors(card):
    """The host C++ backends copy CUDA inputs to the host and return on the
    caller's device, with the same values as from host inputs."""
    from keystone_tpu_torch.ops import gmm, sift

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.random((2, 48, 40)).astype(np.float32))
    ext = sift.SIFTExtractor(num_scales=2, backend="native")
    got = ext(imgs.to(card))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), ext(imgs))
    x = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    est = gmm.GaussianMixtureModelEstimator(k=3, max_iter=5, backend="native")
    m_card, m_host = est.fit(x.to(card)), est.fit(x)
    assert m_card.means.device.type == "cuda"
    assert torch.equal(m_card.means.cpu(), m_host.means)
    batch = torch.from_numpy(rng.normal(size=(2, 8, 20)).astype(np.float32))
    fv = gmm.FisherVector(gmm=m_card, backend="native")
    assert torch.equal(fv(batch.to(card)).cpu(), fv(batch))


def test_cuda_fit_state_round_trip(card, tmp_path):
    """A NormalEqState on the card saves from one host copy and loads back
    onto the card bit for bit; the refit daemon folds onto it there."""
    from keystone_tpu_torch.learn.merge import load_fit_state, save_fit_state
    from keystone_tpu_torch.ops.linear import LinearMapEstimator

    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(500, 64)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32)).to(card)
    est = LinearMapEstimator(lam=0.1)
    state = est.fit_stats_update(est.fit_stats_init(64, 3, card), a, b)
    path = str(tmp_path / "s.ksts")
    save_fit_state(state, path, est=est, rows=500)
    fs = load_fit_state(path)
    assert fs.state.ata.device.type == "cuda"
    for f in ("ata", "atb", "mean_a", "mean_b", "n"):
        assert torch.equal(getattr(fs.state, f), getattr(state, f)), f


def test_hot_swap_captures_while_serving(card, tmp_path):
    """A swap captures the candidate's bucket graphs on the card while six
    threads replay the incumbent's: no request fails, and the served
    answers come from the candidate once the swap returns."""
    import threading

    from keystone_tpu_torch.core.pipeline import Pipeline
    from keystone_tpu_torch.core.serialization import save_fitted
    from keystone_tpu_torch.learn.swap import ModelSwapper
    from keystone_tpu_torch.ops.linear import LinearMapEstimator
    from keystone_tpu_torch.ops.util import MaxClassifier
    from keystone_tpu_torch.serve.export import ExportedApply
    from keystone_tpu_torch.serve.server import ServeApp

    rng = np.random.default_rng(2)
    a = rng.normal(size=(400, 32)).astype(np.float32)
    paths = []
    for v in range(3):
        b = (a @ rng.normal(size=(32, 5)).astype(np.float32)).astype(np.float32)
        model = LinearMapEstimator(lam=0.1).fit(torch.from_numpy(a).to(card),
                                                torch.from_numpy(b).to(card))
        paths.append(str(tmp_path / f"v{v}.kst"))
        save_fitted(Pipeline.of(model, MaxClassifier()), paths[-1], version=f"v{v}",
                    sample=a[:1])
    from keystone_tpu_torch.core.serialization import load_fitted

    first = load_fitted(paths[0], device=card)
    app = ServeApp(exported=ExportedApply(first, a[:1], buckets=(1, 8, 32), device=card),
                   deadline_ms=1.0, model_version="v0", device=card)
    app.swapper = ModelSwapper(app, source_path=paths[0])
    errors, stop = [], threading.Event()

    def hammer(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            n = int(r.integers(1, 40))
            try:
                assert app.predict(a[:n]).shape == (n,)
            except Exception as e:  # noqa: BLE001 — collected for the assertion
                errors.append(repr(e))

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    try:
        for p in paths[1:]:
            res = app.swapper.swap_to_path(p)
            assert res["capture_s"] > 0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        app.shutdown()
    assert errors == [] and app.swap_count == 2 and app.model_version == "v2"
    want = load_fitted(paths[2], device=card)(torch.from_numpy(a[:8]).to(card))
    assert torch.equal(app.exported(a[:8]).cpu(), want.cpu())


# --- the resilience tier on the card ----------------------------------------------


def test_guarded_step_on_card_skips_a_nan_step_bit_for_bit(card):
    """A ``train.nan`` step under the guard leaves the parameters, both
    moments and the device count as they were; a clean guarded step is
    the plain step's, bit for bit."""
    import importlib

    from keystone_tpu_torch.models import lm

    train_mod = importlib.import_module("keystone_tpu_torch.models.lm.train")

    def model():
        return lm.TransformerLM.create(vocab=64, max_seq=64, dim=64, depth=2, num_heads=4,
                                       device=card, generator=torch.Generator(card).manual_seed(0))

    corpus = lm.synthetic_corpus(4000, 64, seed=1)
    toks = torch.from_numpy(train_mod._step_batch(corpus, 0, 0, 4, 32)).to(card)
    opt = train_mod.make_optimizer(3e-4)
    plain, guarded = model(), model()
    ps = opt.init(plain.leaves())
    train_mod.make_train_step(opt)(plain, ps, toks)
    gs = opt.init(guarded.leaves())
    gs.count = torch.zeros((), dtype=torch.int64, device=card)
    step = train_mod.make_train_step(opt, guarded=True)
    step(guarded, gs, toks, False)
    snap = lambda m, s: [t.clone() for t in (*m.leaves(), *s.mu, *s.nu)]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(snap(guarded, gs), snap(plain, ps)))
    before, count = snap(guarded, gs), int(gs.count)
    _, _, loss = step(guarded, gs, toks, True)
    torch.cuda.synchronize()
    assert torch.isnan(loss) and int(gs.count) == count == 1
    assert all(torch.equal(a, b) for a, b in zip(snap(guarded, gs), before))


@pytest.fixture(scope="module")
def lm_fleet():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the replicas serve the LM on it")
    import os

    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.serve import fleet

    fleet.prebuild_kernels()
    built = sorted(os.listdir(BUILD_DIR))
    args = ["--device", "cuda", "--vocab", "256", "--dim", "64", "--depth", "2", "--heads", "4",
            "--s-max", "256", "--slots", "2", "--max-new", "4", "--quantize"]
    f = fleet.Fleet(cmd=fleet.replica_command("lm", args), n=2, poll_s=0.1, grace_s=10.0,
                    boot_timeout_s=300.0, deadline_ms=60_000.0)
    f.start(wait_up=2, timeout=300.0)
    yield f, built
    f.shutdown(grace_s=10.0)


def test_two_replicas_share_the_routers_kernel_build(lm_fleet):
    import os

    from keystone_tpu_torch.core.kernels import BUILD_DIR

    f, built = lm_fleet
    assert sorted(os.listdir(BUILD_DIR)) == built  # no replica built (or half-built) a kernel
    for r in f.replicas:
        code, health = fleet_http(r, "GET", "/healthz")
        assert code == 200 and health["device"].startswith("cuda")
        assert health["peak_memory_bytes"] > 0 and health["cold_start_s"] > 0
        # the replica's own count of what one replay of each captured graph
        # launches: K2 once a block in a prefill, K4 six times a block in
        # the pooled step and in a prefill of at most 64 rows
        cap = health["captured_launches"]
        assert (cap["step"]["flash_attention"], cap["step"]["int8_matmul"]) == (0, 12)
        assert cap["prefill"] and all(
            (n["flash_attention"], n["int8_matmul"]) == (2, 12 if int(w) <= 64 else 0)
            for w, n in cap["prefill"].items())


def fleet_http(r, method, path, body=None):
    from keystone_tpu_torch.serve.fleet import http_transport

    return http_transport(r, method, path, body, timeout=60.0)


def test_a_replica_killed_mid_generate_fails_over(lm_fleet):
    """A replica is SIGKILLed while a long ``/generate`` is in flight on it
    and its decode graph replays: the request comes back whole, with the
    tokens it gives on a healthy tier, and the replica is relaunched."""
    import threading
    import time

    from keystone_tpu_torch.observe import metrics

    f, _ = lm_fleet
    body = {"prompt": list(range(1, 9)), "max_new": 240}
    want = f.forward("/generate", body, kind="generate")["tokens"]
    assert len(want) == 240
    replays = {r.rid: fleet_http(r, "GET", "/healthz")[1]["graph_replays"]["step"]
               for r in f.replicas}
    before = metrics.get_registry().snapshot().get("fleet_failover", 0)
    out = {}
    client = threading.Thread(
        target=lambda: out.update(f.forward("/generate", body, kind="generate")))
    client.start()
    deadline = time.monotonic() + 60.0
    victim = None
    while victim is None and client.is_alive() and time.monotonic() < deadline:
        victim = next((r for r in f.replicas if r.inflight > 0), None)
        time.sleep(0.0005)
    assert victim is not None
    while (client.is_alive() and time.monotonic() < deadline
           and fleet_http(victim, "GET", "/healthz")[1]["graph_replays"]["step"]
           == replays[victim.rid]):
        time.sleep(0.002)
    assert client.is_alive() and victim.inflight == 1  # mid-decode on the victim
    f.kill_replica(victim)
    client.join(timeout=120.0)
    assert not client.is_alive() and out["tokens"] == want
    assert metrics.get_registry().snapshot().get("fleet_failover", 0) >= before + 1
    deadline = time.monotonic() + 300.0  # the killed replica is relaunched and back up
    while time.monotonic() < deadline and not (
            sum(r.restarts for r in f.replicas) == 1 and all(r.state == "up" for r in f.replicas)):
        time.sleep(0.1)
    assert sum(r.restarts for r in f.replicas) == 1 and all(r.state == "up" for r in f.replicas)


def test_k1_node_profile_reads_the_cpus_flops(card):
    """A K1 node's cost profile counts the wrapper's N·D·(D+1) on the card
    (a ctypes launch the FLOP counter never sees) and on the CPU (where
    the plain version runs outside the counter): the same FLOPs; the
    card's profile adds its allocator bytes."""
    from keystone_tpu_torch.core.pipeline import transformer
    from keystone_tpu_torch.observe import cost

    a = torch.from_numpy(np.random.default_rng(3).normal(size=(2048, 512)).astype(np.float32))
    node = transformer(gram.ata_int8, name="gram")
    before = gram.INT8_GRAM.launches
    on_card = cost.analyze(lambda n, b: n(b), node, a.to(card))
    on_cpu = cost.analyze(lambda n, b: n(b), node, a)
    assert gram.INT8_GRAM.launches == before + 1
    assert on_card["flops"] == on_cpu["flops"] == 2048.0 * 512 * 513
    assert on_card["peak_bytes"] >= on_card["argument_bytes"] + on_card["output_bytes"]
    assert on_cpu["peak_bytes"] is None


def test_tuned_and_stored_fit_launches_k1_per_chunk(card, tmp_path, monkeypatch):
    """The streamed MNIST-shaped fit under ``KEYSTONE_TUNE=1`` and a plan
    store: K1 launches once a chunk, its first launch bit for bit the plain
    version; the tuner's flush persists the apply plan's record and a
    second run's planned pass takes ``source="store"`` decisions."""
    from keystone_tpu_torch.models import mnist_random_fft as m
    from keystone_tpu_torch.plan import tune

    monkeypatch.setenv("KEYSTONE_PLAN", "1")
    monkeypatch.setenv("KEYSTONE_GRAM_OP", "int8")
    monkeypatch.setenv("KEYSTONE_TUNE", "1")
    monkeypatch.setenv("KEYSTONE_PLAN_STORE", str(tmp_path))
    monkeypatch.delenv("KEYSTONE_STAGE_DEPTH", raising=False)
    first = []
    real = gram.int8_gram

    def spy(q):
        out = real(q)
        if not first:
            first.append((q.clone(), out.clone()))
        return out

    monkeypatch.setattr(gram, "int8_gram", spy)
    argv = ["--synthetic", "20000", "--num-ffts", "4", "--block-size", "1024"]
    try:
        tune.reset()
        before = gram.INT8_GRAM.launches
        res = m.main(argv, device=card)
        chunks = -(-20000 // res["fit_chunk_size"])
        assert gram.INT8_GRAM.launches - before == chunks
        q, out = first[0]
        assert torch.equal(out, gram.int8_gram_plain(q))
        tune.active().flush()
        tune.reset()
        res = m.main(argv, device=card)
        stored = res["apply_decisions"]["train"]
        assert any(d.get("source") == "store" for d in stored)
        assert any(d["action"] == "learned" for d in stored)
    finally:
        tune.reset()


def test_instrument_under_graph_capture_records_no_wall_time(card):
    """``instrument(sync=True)`` inside a CUDA graph capture neither
    synchronizes (which would break the capture) nor times: it counts a
    capture, and the replay computes the node."""
    from keystone_tpu_torch.core.pipeline import Pipeline, transformer
    from keystone_tpu_torch.observe import instrument, metrics

    inst = instrument.instrument(Pipeline.of(transformer(lambda b: b * 2 + 1, name="affine")),
                                 sync=True)
    x = torch.ones(64, device=card)
    inst(x)  # warm
    reg = metrics.get_registry()
    timed = reg.snapshot().get("node_calls{node=00:affine}", 0)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = inst(x)
    torch.cuda.current_stream().wait_stream(stream)
    assert reg.snapshot().get("node_calls{node=00:affine}", 0) == timed
    assert reg.snapshot().get("node_captures{node=00:affine}", 0) >= 1
    x.fill_(3.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(x, 7.0))


def test_device_monitor_peak_is_the_allocators(card):
    from keystone_tpu_torch.observe import devices

    torch.cuda.reset_peak_memory_stats(card)
    block = torch.empty((256, 1 << 20), dtype=torch.uint8, device=card)
    del block
    mon = devices.DeviceMemoryMonitor()
    (sample,) = [s for s in mon.sample() if s["device"] == f"cuda:{torch.cuda.current_device()}"]
    assert sample["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(card)
    assert mon.peak_bytes() >= 256 << 20


def test_step_tracer_windows_keep_every_k2_launch(card, tmp_path):
    """Windows opened after idle gaps, as a train loop opens them: each
    trace is whole past its primer and holds every K2 launch of its steps,
    counted by kernel name."""
    from keystone_tpu_torch.observe import tracing
    from keystone_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((1, 4, 256, 64), generator=gen, device=card, dtype=torch.bfloat16)
               for _ in range(3))
    fa.flash_attention(q, k, v, causal=True)
    tracer = tracing.StepTracer([(s, 2) for s in range(1, 12, 3)], log_dir=str(tmp_path))
    for step in range(13):
        tracer.step(step)
        torch.cuda.synchronize()
        time.sleep(0.2)
        for _ in range(3):
            fa.flash_attention(q, k, v, causal=True)
    tracer.close()
    assert len(tracer.windows) == 4
    for window in tracer.windows:
        assert window["status"] == "ok" and window["lost_device_events"] == 0, window
        with open(window["path"]) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        assert sum(1 for n in names if "attention_kernel" in n) == 6, window


# -- the multi-process layer on the card


_MH_SCRIPT = """
import json, os, sys
sys.path.insert(0, sys.argv[1])
from keystone_tpu_torch.parallel import multihost

mode, rank, port, out = sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]
backend = "nccl" if mode == "nccl" else "gloo"
try:
    device = multihost.initialize(f"127.0.0.1:{port}", 2, rank, init_timeout_s=60,
                                  backend=backend, device="cuda:0")
except RuntimeError as e:
    print("REFUSED:", e, flush=True)
    sys.exit(3)
from keystone_tpu_torch.models import mnist_random_fft
from keystone_tpu_torch.ops import gram
os.environ.update(KEYSTONE_PLAN="1", KEYSTONE_GRAM_OP="int8")
gram.INT8_GRAM.launches = 0
res = mnist_random_fft.main(json.loads(os.environ["MH_ARGV"]))
lo, hi = multihost.row_block(res["n_train"])
rows = min(hi, res["n_train"]) - lo
chunk = res["fit_chunk_size"] // 2
out_rec = {"k1": gram.INT8_GRAM.launches, "chunks": -(-rows // chunk), "device": str(device),
           "pred": res["test_predictions"].tolist(), "test_error": res["test_error"]}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(out_rec, f)
multihost.shutdown()
"""
_MH_ARGV = ["--synthetic", "20000", "--num-ffts", "8", "--block-size", "2048"]


def _mh_pair(mode: str, tmp_path) -> list:
    """Two processes of ``_MH_SCRIPT`` on card 0; their exit codes and
    output."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = str(Path(__file__).resolve().parent.parent)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KEYSTONE_")}
    env["MH_ARGV"] = json.dumps(_MH_ARGV)
    procs = [subprocess.Popen([sys.executable, "-c", _MH_SCRIPT, root, mode, str(r), str(port),
                               str(tmp_path)], env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=240)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_multihost_world_of_one_on_nccl(card, monkeypatch):
    """``initialize`` alone forms a group of one over NCCL on card 0; an
    all-reduce and a ``GlobalRows`` of its rows run on the card."""
    import os

    from keystone_tpu_torch.parallel import multihost

    for key in ("KEYSTONE_COORDINATOR", "KEYSTONE_PROCESS_ID", "KEYSTONE_NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    try:
        device = multihost.initialize()
        assert device.type == "cuda" and multihost.process_count() == 1
        assert torch.distributed.get_backend() == "nccl"
        x = torch.arange(4.0, device=device)
        assert torch.equal(multihost.all_reduce_(x), torch.arange(4.0, device=device))
        rows = multihost.global_batch_from_local(np.ones((5, 3), np.float32))
        assert rows.local.device == device and (rows.n_global, rows.offset) == (5, 0)
    finally:
        multihost.shutdown()
        for key in ("KEYSTONE_COORDINATOR", "KEYSTONE_PROCESS_ID", "KEYSTONE_NUM_PROCESSES"):
            os.environ.pop(key, None)


def test_nccl_refuses_two_ranks_on_one_card(card, tmp_path):
    """Two ranks asking for NCCL on one card are refused by name, pointing
    at ``backend="gloo"``; neither hangs."""
    for out, rc in _mh_pair("nccl", tmp_path):
        assert rc == 3, out
        assert "two ranks on one card" in out and "backend='gloo'" in out, out


def test_two_process_gloo_fit_on_card_launches_k1_per_rank(card, tmp_path, monkeypatch):
    """Two processes on card 0 over gloo: the streamed int8 MNIST fit
    launches K1 once a fit chunk on each rank, and the global test
    predictions agree with one process's on ≥ 99.5 %."""
    from keystone_tpu_torch.models import mnist_random_fft

    outs = _mh_pair("gloo", tmp_path)
    for out, rc in outs:
        assert rc == 0, out
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for rec in recs:
        assert rec["device"] == "cuda:0" and rec["k1"] == rec["chunks"] > 0, rec
    assert recs[0]["pred"] == recs[1]["pred"]
    monkeypatch.setenv("KEYSTONE_PLAN", "1")
    monkeypatch.setenv("KEYSTONE_GRAM_OP", "int8")
    one = mnist_random_fft.main(list(_MH_ARGV))
    agree = float(np.mean(np.asarray(recs[0]["pred"]) == one["test_predictions"]))
    assert agree >= 0.995, agree


# -- tensor, pipeline and sequence parallelism on the card


def _card_lm(card, depth=2, **kw):
    from keystone_tpu_torch.models.lm import TransformerLM

    return TransformerLM.create(vocab=1024, max_seq=256, dim=256, depth=depth, num_heads=8,
                                device=card, generator=torch.Generator(device=card).manual_seed(0),
                                **kw)


def _leaf_grads(model, loss):
    params = model.leaves()
    for p in params:
        p.requires_grad_(True)
    grads = torch.autograd.grad(loss(model), params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def test_tp_step_on_card_named_four_times_matches_unsharded(card):
    """A tensor-parallel f32 model over a model axis naming the card four
    times: K2 once a block a position at (B, H/4, S, D), and the loss and
    every leaf's gradient within 1e-5 of the unsharded model's."""
    from keystone_tpu_torch.models.lm import next_token_loss, shard_params
    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.parallel import create_mesh

    toks = torch.randint(0, 1024, (4, 257), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    plain = _card_lm(card)
    want_loss = next_token_loss(plain, toks)
    want = _leaf_grads(plain, lambda m: next_token_loss(m, toks))
    tp = shard_params(_card_lm(card), create_mesh(data=1, model=4, devices=[card] * 4))
    assert tp.tp.attn and tp.tp.ffn and tp.tp.vocab
    before = fa.FLASH_ATTENTION.launches
    loss = next_token_loss(tp, toks)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION.launches - before == 2 * 4
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for g, w in zip(_leaf_grads(tp, lambda m: next_token_loss(m, toks)), want):
        assert float((g - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)


def test_gpipe_on_card_named_four_times_matches_local(card):
    """The LM's GPipe forward over four stages naming the card four
    times: K2 once a block a microbatch, logits within 1e-5 of max|logit|
    of the plain forward."""
    from keystone_tpu_torch.models.lm import pp_forward
    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.parallel import create_mesh

    model = _card_lm(card, depth=4)
    toks = torch.randint(0, 1024, (8, 256), device=card,
                         generator=torch.Generator(device=card).manual_seed(2))
    with torch.no_grad():
        want = model(toks)
        before = fa.FLASH_ATTENTION.launches
        got = pp_forward(model, toks, create_mesh(data=1, model=4, devices=[card] * 4), n_micro=4)
        torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION.launches - before == 4 * 4
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


_SP_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from keystone_tpu_torch.ops import attention, flash_attention as fa
from keystone_tpu_torch.parallel import create_mesh, multihost

rank, port, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
device = multihost.initialize(f"127.0.0.1:{port}", 2, rank, init_timeout_s=60, backend="gloo",
                              device="cuda:0")
gen = torch.Generator(device=device).manual_seed(0)
q, k, v = (torch.randn((2, 4, 1024, 64), generator=gen, device=device) for _ in range(3))
before = fa.FLASH_ATTENTION_STEP.launches
ring = attention.ring_attention(q, k, v, create_mesh(), causal=True)
torch.cuda.synchronize()
k3 = fa.FLASH_ATTENTION_STEP.launches - before
full = fa.flash_attention(q, k, v, causal=True)
err = float((ring - full).abs().max() / full.abs().max())
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump({"k3": k3, "err": err}, f)
multihost.shutdown()
"""


def test_two_process_gloo_ring_on_card_counts_k3(card, tmp_path):
    """Two processes on card 0 over gloo run the causal ring across the
    process boundary: K3 once a live hop on each rank (rank r: r + 1), the
    output within 1e-5 of max|out| of full-sequence K2."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = str(Path(__file__).resolve().parent.parent)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KEYSTONE_")}
    procs = [subprocess.Popen([sys.executable, "-c", _SP_SCRIPT, root, str(r), str(port),
                               str(tmp_path)], env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [(p.communicate(timeout=240)[0], p.returncode) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out, rc in outs:
        assert rc == 0, out
    for r in range(2):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec["k3"] == r + 1 and rec["err"] <= 1e-5, rec


_TP_SERVE_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from keystone_tpu_torch.models.lm import TransformerLM, generate, prefill, shard_params
from keystone_tpu_torch.ops import flash_attention as fa, int8_matmul
from keystone_tpu_torch.parallel import create_mesh, multihost
from keystone_tpu_torch.serve.export import export_lm

rank, port, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
device = multihost.initialize(f"127.0.0.1:{port}", 2, rank, init_timeout_s=60, backend="gloo",
                              device="cuda:0")
whole = TransformerLM.create(vocab=512, max_seq=128, dim=256, depth=2, num_heads=4,
                             device=device, generator=torch.Generator(device=device).manual_seed(0))
model = shard_params(whole, create_mesh(data=1, model=2))
prompt = torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(1))
before = fa.FLASH_ATTENTION.launches
got, cache = prefill(model, prompt, 64)
k2 = fa.FLASH_ATTENTION.launches - before
want = prefill(whole, prompt, 64)[0]
toks = generate(model, prompt, max_new=8)
loop = export_lm(model, slots=2, s_max=64, quantize=True, max_new=8)
before = int8_matmul.INT8_MATMUL.launches
outs = loop.run([prompt[0].numpy(), prompt[1, :9].numpy()])
torch.cuda.synchronize()
rec = {"k2": k2, "k4": int8_matmul.INT8_MATMUL.launches - before, "heads": cache.k.shape[2],
       "err": float((got - want).abs().max() / want.abs().max()), "graphed": loop.graphed,
       "tokens": toks.tolist(), "loop": [o.tolist() for o in outs]}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(rec, f)
multihost.shutdown()
"""


def test_two_process_gloo_tp_serving_on_card(card, tmp_path):
    """Two processes on card 0 over gloo serve a model sharded over a model
    axis across them: each rank's prefill launches K2 once a block for its
    two heads, and its cache holds those heads; the prefill logits within
    1e-5 of max|logit| of the whole model's; ``generate`` and the slot pool
    of ``export_lm(quantize=True)`` give the same tokens on both ranks, the
    pool eager (a gloo group cannot be captured) with K4 six times a block
    in every forward."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = str(Path(__file__).resolve().parent.parent)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("KEYSTONE_", "KST_"))}
    procs = [subprocess.Popen([sys.executable, "-c", _TP_SERVE_SCRIPT, root, str(r), str(port),
                               str(tmp_path)], env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [(p.communicate(timeout=240)[0], p.returncode) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out, rc in outs:
        assert rc == 0, out
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for rec in recs:
        assert rec["k2"] == 2 and rec["heads"] == 2 and rec["err"] <= 1e-5, rec
        assert not rec["graphed"] and rec["k4"] > 0 and rec["k4"] % 12 == 0, rec
    assert recs[0]["tokens"] == recs[1]["tokens"] and recs[0]["loop"] == recs[1]["loop"]
    assert [len(t) for t in recs[0]["loop"]] == [8, 8]


_WEIGHTED_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from keystone_tpu_torch.ops import weighted_linear as wl
from keystone_tpu_torch.parallel import multihost

rank, port, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
device = multihost.initialize(f"127.0.0.1:{port}", 2, rank, init_timeout_s=60, backend="gloo",
                              device="cuda:0")
rng = np.random.default_rng(11)
n, d, c = 4096, 256, 12
cls = rng.integers(0, c, size=n)
a = (rng.normal(size=(c, d))[cls] * 2 + rng.normal(size=(n, d))).astype(np.float32)
y = -np.ones((n, c), np.float32)
y[np.arange(n), cls] = 1.0
lo, hi = rank * n // 2, (rank + 1) * n // 2
est = wl.BlockWeightedLeastSquaresEstimator(block_size=128, num_iter=2, lam=1e-2, class_chunk=4)
rows = multihost.global_batch_from_local(a[lo:hi])
got = est.fit(rows, torch.from_numpy(y[lo:hi]).to(device))
one = est.fit(multihost.GlobalRows(torch.from_numpy(a).to(device), n, 0),
              torch.from_numpy(y).to(device))
w, w1 = torch.cat(list(got.xs)), torch.cat(list(one.xs))
scale = float(w1.abs().max())
rec = {"device": str(rows.local.device), "rows": rows.n_valid,
       "err": float((w - w1).abs().max()) / scale,
       "b_err": float((got.b - one.b).abs().max()) / max(scale, float(one.b.abs().max())),
       "w": w.cpu().numpy().ravel()[:64].tolist()}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(rec, f)
multihost.shutdown()
"""


def test_two_process_gloo_weighted_fit_on_card(card, tmp_path):
    """Two processes on card 0 over gloo fit the class-weighted solver to a
    global batch, half the rows each: the fit runs on the card on each
    rank's own rows, both ranks hold the same model, and it is within 1e-4
    of max|W| (``tests/test_torch_weighted.py``'s bar) of one process's
    fit of the same rows as a global batch."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = str(Path(__file__).resolve().parent.parent)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("KEYSTONE_", "KST_"))}
    procs = [subprocess.Popen([sys.executable, "-c", _WEIGHTED_SCRIPT, root, str(r), str(port),
                               str(tmp_path)], env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [(p.communicate(timeout=240)[0], p.returncode) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out, rc in outs:
        assert rc == 0, out
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for rec in recs:
        assert rec["device"] == "cuda:0" and rec["rows"] == 2048, rec
        assert rec["err"] <= 1e-4 and rec["b_err"] <= 1e-4, rec
    assert recs[0]["w"] == recs[1]["w"]
