"""KV-cache serving for the transformer LM: prefill → decode → sample.
Port of ``keystone_tpu/models/lm/decode.py``.

The cache is preallocated at its full length. Where the JAX package
returns a new cache from each step (``dynamic_update_slice``), the port
writes the new position into the cache's tensors in place: a
:class:`KVCache` returned by :func:`decode_step` shares its buffers with
the one passed in. A per-row write is an indexed write of each row's
position. :func:`generate` is a Python loop over decode steps; with an
``eos_id`` it stops once every row has emitted it.

A tensor-parallel model (``shard_params``) serves as it trains: each
position of the model axis runs its heads, its MLP columns and its vocab
rows, and the partial sums add up over the axis. The cache is split over
its KV-head axis, as the JAX package's comes back sharded
(``P(None, None, 'model')``): across processes each rank holds its
(L, B, KV/n, S_max, hd) heads; in one process the cache is whole and each
position writes and reads its heads' slice, a view along dim 2. Where the
heads do not split over the axis the attention and the cache stay whole.
The logits go through the model's vocab-sharded logits, gathered over the
axis.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from keystone_tpu_torch.models.lm.model import (
    LMBlock,
    TransformerLM,
    _block_apply,
    _embed,
    embed_rows,
    model_mm,
)
from keystone_tpu_torch.models.lm.sharding import leaf_dims
from keystone_tpu_torch.ops.quantization import QTensor, quantize_int8, symmetric_int8


@dataclasses.dataclass
class KVCache:
    """Preallocated decode cache: (L, B, KV_heads, S_max, hd) buffers and
    the position of the next token — an ``int`` when every row is at the
    same position, a (B,) tensor when each row has its own (the slot
    pool). With ``kv_dtype="int8"`` the buffers hold per-position int8
    codes with (L, B, KV_heads, S_max, 1) f32 scales, which pull out of
    both attention products exactly."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int | torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def _kv_quant(t):
    """(..., hd) → (int8 codes, f32 scale (..., 1)) per position."""
    return symmetric_int8(t, (-1,))


def _tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def cache_heads(model: TransformerLM) -> int:
    """The KV heads this process's cache holds: a rank's share across
    processes under a layout that splits the heads, else every head."""
    tp = model.tp
    if tp is not None and tp.attn and tp.local:
        return model.kv_heads // tp.n
    return model.kv_heads


@torch.inference_mode()
def prefill(model: TransformerLM, tokens, s_max: int,
            kv_dtype: str | None = None, lengths=None):
    """Run the prompt through the model once, capturing each layer's K/V
    into an ``s_max``-long cache (optionally int8). Returns (last-position
    logits (B, V) f32, cache). ``lengths`` ((B,) ints) admits right-padded
    prompts of unequal length: logits come from each row's last real token
    and the cache carries a per-row ``pos``."""
    if model.seq_mode != "local":
        raise ValueError("prefill/decode require seq_mode='local'")
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype={kv_dtype!r}; expected None|'int8'")
    cdt = model.cdt
    tokens = _tokens(tokens, model.device)
    n, s = tokens.shape
    if s > s_max:
        raise ValueError(f"prompt length {s} exceeds s_max={s_max}")
    x = _embed(model, tokens, cdt)
    mm_fn = model_mm(model)
    ffn = model._ffn()
    ks, vs = [], []
    for i, blk in enumerate(model.blocks):
        x, (k, v), _ = _block_apply(
            x, blk, cdt, lambda y, b: model._attention(y, b, return_kv=True),
            moe=model._moe(i), mm_fn=mm_fn, ffn=ffn,
        )
        ks.append(k)
        vs.append(v)
    if lengths is None:
        logits = model.logits(x[:, -1:])[:, 0]
        pos = s
    else:
        lengths = _tokens(lengths, x.device)
        idx = (lengths - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        logits = model.logits(x.gather(1, idx))[:, 0]
        pos = lengths
    shape = (len(ks), n, ks[0].shape[1], s_max, ks[0].shape[-1])
    k_stack = torch.zeros(shape, dtype=ks[0].dtype, device=x.device)
    v_stack = torch.zeros(shape, dtype=vs[0].dtype, device=x.device)
    for i, (k, v) in enumerate(zip(ks, vs)):
        k_stack[i, :, :, :s] = k
        v_stack[i, :, :, :s] = v
    if kv_dtype == "int8":
        kq, ksc = _kv_quant(k_stack)
        vq, vsc = _kv_quant(v_stack)
        return logits, KVCache(k=kq, v=vq, pos=pos, k_scale=ksc, v_scale=vsc)
    return logits, KVCache(k=k_stack, v=v_stack, pos=pos)


def _write(buf, i, val, pos, s_cap):
    """Write the (B, KV_heads, 1, X) new-position slab into layer ``i`` of
    a (L, B, KV_heads, S_max, X) buffer, in place. A scalar position past
    the end lands on the last one, as ``dynamic_update_slice`` clamps; a
    row past the end is not written."""
    val = val[:, :, 0].to(buf.dtype)
    if isinstance(pos, int):
        buf[i, :, :, min(pos, s_cap - 1)] = val
        return
    rows = torch.arange(val.shape[0], device=buf.device)
    idx = pos.clamp(max=s_cap - 1)
    old = buf[i, rows, :, idx]
    buf[i, rows, :, idx] = torch.where((pos < s_cap)[:, None, None], val, old)


@torch.inference_mode()
def decode_step(model: TransformerLM, token, cache: KVCache):
    """One autoregressive step: (B,) tokens at ``cache.pos`` → ((B, V) f32
    logits, the cache with ``pos + 1``). The cache's buffers are written in
    place. Attention reads the whole cache with positions past ``pos``
    masked. A row at or past the cache's capacity gets NaN logits."""
    cdt = model.cdt
    d = model.embed.shape[-1]
    h = model.num_heads
    hd = d // h
    token = _tokens(token, model.device)
    n = token.shape[0]
    pos = cache.pos
    vec = isinstance(pos, torch.Tensor) and pos.ndim >= 1
    if isinstance(pos, torch.Tensor) and not vec:
        pos = int(pos)
    s_cap = cache.k.shape[3]
    x = embed_rows(model, token)[:, None] * math.sqrt(d)
    if model.pos_encoding == "learned":
        last = model.pos_embed.shape[0] - 1
        if vec:
            x = x + model.pos_embed[pos.clamp(max=last)][:, None]
        else:
            x = x + model.pos_embed[min(pos, last)]
    x = x.to(cdt)

    ar = torch.arange(s_cap, device=x.device)
    if vec:
        valid = (ar[None, :] <= pos[:, None])[:, None, None, :]
        positions = pos[:, None]
    else:
        valid = (ar <= pos)[None, None, None, :]
        positions = torch.tensor([pos], device=x.device)
    quantized = cache.k_scale is not None
    mm_fn = model_mm(model)
    ffn = model._ffn()
    tp = model.tp

    def cached(i, q, k1, v1, heads):
        """Write the new position's K/V of ``heads`` into layer ``i`` of the
        cache and attend the (n, h, 1, hd) queries over those heads' cache:
        (n, h, 1, hd) f32."""
        dev = cache.k.device
        q, k1, v1 = q.to(dev), k1.to(dev), v1.to(dev)
        k_buf, v_buf = cache.k[:, :, heads], cache.v[:, :, heads]
        if quantized:
            ks_buf, vs_buf = cache.k_scale[:, :, heads], cache.v_scale[:, :, heads]
            k1, k1s = _kv_quant(k1)
            v1, v1s = _kv_quant(v1)
            _write(ks_buf, i, k1s, pos, s_cap)
            _write(vs_buf, i, v1s, pos, s_cap)
        _write(k_buf, i, k1, pos, s_cap)
        _write(v_buf, i, v1, pos, s_cap)
        # grouped attention: q heads regroup as (KV, G) against the KV-head
        # cache. Operands in the compute dtype, widened to f32 (bf16
        # products are exact in f32): f32 scores and output, as the JAX
        # package's f32-result einsums
        kvh = k1.shape[1]
        qg = q.reshape(n, kvh, q.shape[1] // kvh, 1, hd).to(cdt).to(torch.float32)
        scores = torch.einsum(
            "bkgqd,bksd->bkgqs", qg, k_buf[i].to(cdt).to(torch.float32)
        ) / math.sqrt(hd)
        if quantized:
            scores = scores * ks_buf[i][..., 0][:, :, None, None, :]
        scores = torch.where(valid[:, :, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        if quantized:
            probs = probs * vs_buf[i][..., 0][:, :, None, None, :]
        out = torch.einsum(
            "bkgqs,bksd->bkgqd", probs.to(cdt).to(torch.float32),
            v_buf[i].to(cdt).to(torch.float32),
        )
        return out.reshape(n, q.shape[1], 1, hd)

    def cached_attn(i):
        def attn(y, blk):
            if tp is not None and tp.attn:
                kvh = model.kv_heads // tp.n

                def attend(p, q, k1, v1):
                    heads = slice(None) if tp.local else slice(p * kvh, (p + 1) * kvh)
                    return cached(i, q, k1, v1, heads).to(q.device)

                return model._attention_tp(y, blk, positions=positions, attend=attend), None
            q, k1, v1 = model._qkv_heads(y, blk, positions=positions)
            out = cached(i, q, k1, v1, slice(None))
            return mm_fn(out.transpose(1, 2).reshape(n, 1, d).to(cdt), blk.wo, cdt), None

        return attn

    for i, blk in enumerate(model.blocks):
        x, _, _ = _block_apply(x, blk, cdt, cached_attn(i), moe=model._moe(i), mm_fn=mm_fn,
                               ffn=ffn)
    logits = model.logits(x)[:, 0]
    # past capacity the write above landed on the last position: the
    # logits are plausible but wrong, so they are poisoned loudly
    if vec:
        logits = torch.where((pos < s_cap)[:, None], logits, float("nan"))
    elif pos >= s_cap:
        logits = torch.full_like(logits, float("nan"))
    return logits, dataclasses.replace(cache, pos=pos + 1)


def _filter_logits(logits, top_k: int, top_p: float):
    """Top-k then nucleus filtering on (B, V) logits (already temperature-
    scaled): everything outside the keep-set drops to −inf. One descending
    sort serves both filters."""
    v = logits.shape[-1]
    if top_k < 0 or top_k > v:
        raise ValueError(f"top_k={top_k} outside [0, vocab={v}]")
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    # a fill on the logits' device, not a copy from the host: the sampler
    # runs inside the decode loop's captured CUDA graphs
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype, device=logits.device)
    if top_k:
        kth = sorted_l[:, top_k - 1][:, None]
        logits = torch.where(logits >= kth, logits, neg_inf)
        # the nucleus below must see the top-k-filtered distribution
        ranks = torch.arange(v, device=logits.device)[None, :]
        sorted_l = torch.where(ranks < top_k, sorted_l, neg_inf)
    if top_p:
        probs = torch.softmax(sorted_l, dim=-1)
        # exclusive cumulative mass before each token: a token stays while
        # the mass above it is < top_p (the first token always stays)
        csum = torch.cumsum(probs, dim=-1) - probs
        keep = csum < top_p
        thresh = torch.where(keep, sorted_l, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, neg_inf)
    return logits


def pick(logits, temperature: float, top_k: int, top_p: float,
         generator: torch.Generator | None):
    """Greedy (temperature 0) or sampled next tokens from (B, V) logits.
    Sampling draws from ``generator``; it cannot reproduce
    ``jax.random``'s bits."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    # temperature first: the nucleus cut measures the sampled distribution
    logits = _filter_logits(logits / temperature, top_k, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(
    model: TransformerLM,
    prompt,
    *,
    max_new: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    kv_dtype: str | None = None,
    generator: torch.Generator | None = None,
    prompt_lens=None,
    eos_id: int | None = None,
) -> torch.Tensor:
    """Greedy (temperature 0) or sampled decode of ``max_new`` tokens after
    ``prompt`` (B, P). Returns (B, max_new) int32 on the model's device.
    ``prompt_lens`` admits right-padded prompts of unequal length;
    ``eos_id`` freezes a row at its first EOS (EOS-filled after) and stops
    once every row has finished."""
    dev = model.device
    prompt = _tokens(prompt, dev)
    s_max = prompt.shape[1] + max_new
    if model.pos_encoding == "learned" and s_max > model.pos_embed.shape[0]:
        raise ValueError(
            f"prompt+max_new={s_max} exceeds max_seq={model.pos_embed.shape[0]}"
        )
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    logits, cache = prefill(model, prompt, s_max, kv_dtype=kv_dtype, lengths=prompt_lens)
    tok = pick(logits, temperature, top_k, top_p, generator)
    out = [tok]
    done = None if eos_id is None else tok == eos_id
    for _ in range(1, max_new):
        if done is not None and bool(done.all()):
            break
        logits, cache = decode_step(model, tok, cache)
        tok = pick(logits, temperature, top_k, top_p, generator)
        if done is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok)
    res = torch.stack(out, dim=1).to(torch.int32)
    if res.shape[1] < max_new:
        pad = torch.full(
            (res.shape[0], max_new - res.shape[1]), eos_id, dtype=torch.int32, device=dev
        )
        res = torch.cat([res, pad], dim=1)
    return res


def quantize_for_decode(model: TransformerLM) -> TransformerLM:
    """Weight-only int8 for serving: every block matrix gets symmetric
    per-output-channel int8, the tied embedding per-row scales (serving
    both the gather and the logit transpose). The learned position table
    and the MoE experts stay full precision, as in the JAX package, and a
    MoE block's zero-width FFN placeholders stay as they are.

    A sharded model quantizes as the JAX package's GSPMD does, to the whole
    model's codes and scales: in one process the whole leaves quantize and
    each position's pieces are made once (``TensorParallel.with_pieces``);
    across processes a rank's rows of ``wo``/``w2`` take their per-column
    max |w| over the model axis before rounding, and the column pieces
    and the embedding's vocab rows need no collective."""
    tp = model.tp
    dims = leaf_dims(model)[2:]

    def qmat(w, dim):
        if not w.numel():
            return w
        w = w.detach()
        if tp is not None and tp.local and dim == 0:
            amax = tp.comm.pmax([torch.amax(w.abs().to(torch.float32), dim=0, keepdim=True)])
            return QTensor(*symmetric_int8(w, (0,), amax=amax))
        return quantize_int8(w)

    blocks = [
        LMBlock(*(qmat(w, dims[6 * i + j]) for j, w in enumerate(blk.leaves())))
        for i, blk in enumerate(model.blocks)
    ]
    out = model.replace(
        embed=quantize_int8(model.embed.detach(), channel_axis=0), blocks=blocks
    )
    if tp is not None:
        out = out.replace(tp=tp.with_pieces(out.leaves(), leaf_dims(out)))
    return out
