"""Decoder-only transformer LM — port of ``keystone_tpu/models/lm/model.py``.

Pre-LN blocks, tied-embedding logits, learned or rotary positions, MHA or
grouped-query attention, and a compute dtype apart from the f32 weights
(LayerNorm statistics and the logits stay f32). The local attention is the
flash kernel K2 on the card and dense attention on the CPU
(``KST_LOCAL_ATTN`` = auto | flash | dense, read per call). Weight-only
int8 block matrices multiply through :func:`model_mm`: the plain
``quantization.mm`` (``int8_kernel="mm"``, the JAX package's "xla") or
kernel K4 (``"kernel"``, the JAX package's "pallas") for decode-sized rows.

``seq_mode`` "ring" and "ulysses" run the attention sequence-parallel
over ``seq_axis`` of ``mesh`` (:mod:`keystone_tpu_torch.ops.attention`):
the ring's hops are kernel K3 on the card, Ulysses' local attention K2.
A model built with no mesh takes the ambient one of ``use_mesh``.

``tp`` (set by :func:`keystone_tpu_torch.models.lm.sharding.shard_params`)
runs the model tensor-parallel over a mesh's ``model`` axis, Megatron
style: each position computes its heads (K2 at (B, H/n, S, D)) and its
columns of the MLP, the row-parallel products' partial sums are added over
the axis (two collectives a block, one around the attention and one around
the MLP), the embedding lookup over a vocab shard is masked and summed,
the tied logits stay vocab-sharded for the loss
(:mod:`~keystone_tpu_torch.models.lm.losses`), and a MoE layer runs its
own experts on the dispatch the whole router computed.

Float weights are ``nn.Parameter``s made without ``requires_grad``;
training (``models/lm/train.py``'s step) turns it on for every float
leaf. ``remat`` recomputes each block in the backward under
``torch.utils.checkpoint`` (:func:`remat_wrap`). ``moe_layers`` holds a
top-2 routed :class:`~keystone_tpu_torch.ops.moe.MoELayer` (or None) per
block; a MoE block's expert layer replaces its dense FFN, whose ``w1`` and
``w2`` are zero-width placeholders, and its load-balance aux adds up over
the blocks.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.ops.attention import (
    dense_attention,
    ring_attention,
    ulysses_attention,
)
from keystone_tpu_torch.ops.flash_attention import flash_attention_trainable
from keystone_tpu_torch.ops.int8_matmul import mm_fused
from keystone_tpu_torch.ops.moe import MoELayer
from keystone_tpu_torch.ops.quantization import QTensor, mm
from keystone_tpu_torch.ops.vit import _layer_norm
from keystone_tpu_torch.parallel.mesh import current_mesh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")
_SEQ_MODES = ("local", "ring", "ulysses")


def _leaf(w):
    """A float tensor becomes a Parameter that needs no gradient; a
    QTensor stays as it is."""
    if isinstance(w, QTensor):
        return w
    return nn.Parameter(w, requires_grad=False)


class LMBlock(nn.Module):
    """One block's matrices: wq (d, d), wk/wv (d, kv_dim), wo (d, d),
    w1 (d, ff), w2 (ff, d); each a tensor or a :class:`QTensor`."""

    def __init__(self, wq, wk, wv, wo, w1, w2):
        super().__init__()
        for name, w in zip(_WEIGHTS, (wq, wk, wv, wo, w1, w2)):
            setattr(self, name, _leaf(w))

    def leaves(self) -> tuple:
        return tuple(getattr(self, n) for n in _WEIGHTS)


def _ln(x, cdt):
    # statistics in f32 even under a bf16 policy
    return _layer_norm(x.to(torch.float32)).to(cdt)


def model_mm(model):
    """The matmul the model's weights go through: plain ``mm`` or, under
    ``int8_kernel="kernel"``, K4 for per-output-channel QTensors with at
    most 64 rows (float weights always take ``mm``)."""
    if model.int8_kernel == "mm":
        return mm
    if model.int8_kernel != "kernel":
        raise ValueError(
            f"int8_kernel={model.int8_kernel!r}; expected mm|kernel"
        )

    def kernel_mm(y, w, dt):
        m_rows = math.prod(y.shape[:-1])
        if (
            isinstance(w, QTensor)
            and tuple(w.scale.shape) == (1, w.q.shape[1])
            and m_rows <= 64
        ):
            return mm_fused(y.to(dt).contiguous(), w).to(dt)
        return mm(y, w, dt)

    return kernel_mm


def _split_heads(y, w, h, mm_fn=mm):
    n, s, _ = y.shape
    out = mm_fn(y, w, y.dtype)  # (n, s, h·hd) — rectangular for GQA K/V
    return out.reshape(n, s, h, out.shape[-1] // h).transpose(1, 2)


def _rope(x, positions, base: float = 10_000.0):
    """Rotary position embedding. x: (..., S, hd), hd even; positions (S,)
    or (B, S) (each batch row at its own phase). Angles in f32, the
    rotated result back in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    inv = base ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    freqs = positions.to(torch.float32)[..., None] * inv  # (..., S, half)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if freqs.ndim == 3:
        cos, sin = cos[:, None], sin[:, None]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _mlp(y, w1, w2, cdt, mm_fn=mm):
    """The dense FFN (or one position's columns of it). The GELU is the
    tanh approximation, ``jax.nn.gelu``'s default."""
    return mm_fn(F.gelu(mm_fn(y, w1, cdt), approximate="tanh"), w2, cdt)


def _block_apply(x, blk: LMBlock, cdt, attn, moe=None, mm_fn=mm, ffn=None):
    """Pre-LN residual block shared by the forward, prefill and decode:
    ``attn(y, blk) -> (attention output (N, S, d), aux)``. ``moe``, when
    given, replaces the dense FFN; ``ffn(y, blk)``, when given, computes
    it (the tensor-parallel one). Returns (x, attn aux, MoE aux loss —
    None for a dense FFN, where the JAX package returns a constant 0)."""
    a, aux = attn(_ln(x, cdt), blk)
    x = x + a
    y = _ln(x, cdt)
    if moe is not None:
        f, moe_aux = moe(y)
        return x + f, aux, moe_aux
    if ffn is not None:
        return x + ffn(y, blk), aux, None
    return x + _mlp(y, blk.w1, blk.w2, cdt, mm_fn), aux, None


def _gather_embed(embed, tokens):
    """Embedding rows for ``tokens``; an int8 row-quantized table applies
    each row's scale to the gathered row."""
    if isinstance(embed, QTensor):
        return embed.q[tokens].to(torch.float32) * embed.scale[tokens]
    return embed[tokens]


def _gather_embed_tp(model, tokens):
    """Embedding rows for ``tokens`` from a vocab-sharded table (float or
    row-quantized): each position gathers the tokens in its rows and zeros
    for the rest, and the sum over the model axis holds each token's row
    once."""
    tp = model.tp
    parts = []
    for pos, dev in zip(tp.comm.positions, tp.comm.devices):
        e = tp.part(model.embed, 0, pos, dev)
        lo, vl = pos * e.shape[0], e.shape[0]
        t = tokens.to(dev)
        rows = _gather_embed(e, (t - lo).clamp(0, vl - 1))
        live = ((t >= lo) & (t < lo + vl))[..., None]
        parts.append(torch.where(live, rows, torch.zeros((), dtype=rows.dtype, device=dev)))
    return tp.comm.psum(parts, device=tokens.device)


def embed_rows(model, tokens):
    """The embedding rows of ``tokens`` under the model's layout."""
    tp = model.tp
    if tp is not None and tp.vocab:
        return _gather_embed_tp(model, tokens)
    return _gather_embed(model.embed, tokens)


def _embed(model, tokens, cdt):
    """Token embedding (× √d) plus learned positions, in the compute
    dtype."""
    d = model.embed.shape[-1]
    x = embed_rows(model, tokens) * math.sqrt(d)
    if model.pos_encoding == "learned":
        x = x + model.pos_embed[: tokens.shape[1]]
    return x.to(cdt)


def _tied_logits(x, embed, cdt):
    """Logits against the tied embedding, in f32. The JAX package multiplies
    compute-dtype operands with an f32 result; here the operands are
    rounded to the compute dtype and then widened to f32, where a product
    of two bf16 values is exact, so only the order of the f32 sum
    differs."""
    return _logits_of(_ln(x, cdt).to(torch.float32), embed, cdt)


def _logits_of(a, embed, cdt):
    """Normalized f32 hidden states ``a`` against a (piece of the) tied
    embedding, float or row-quantized."""
    if isinstance(embed, QTensor):
        # (V, 1) row scales become per-output-channel under the transpose
        return (a @ embed.q.T.to(torch.float32)) * embed.scale[:, 0]
    return a @ embed.T.to(cdt).to(torch.float32)


def _use_flash(x) -> bool:
    """True for the flash kernel: ``KST_LOCAL_ATTN`` = flash | dense, or
    auto (the default) = flash for a CUDA tensor, dense for a CPU one."""
    mode = os.environ.get("KST_LOCAL_ATTN", "auto")
    if mode not in ("auto", "flash", "dense"):
        raise ValueError(f"KST_LOCAL_ATTN={mode!r}; expected auto|flash|dense")
    if mode == "auto":
        return x.device.type == "cuda"
    return mode == "flash"


class TransformerLM(nn.Module):
    """Pre-LN decoder-only LM; logits tied to the token embedding."""

    def __init__(
        self,
        embed,
        pos_embed,
        blocks: Sequence[LMBlock],
        *,
        num_heads: int = 8,
        seq_mode: str = "local",
        mesh=None,
        seq_axis: str = "data",
        remat: bool = False,
        remat_policy: str = "full",
        compute_dtype: str = "float32",
        moe_layers: tuple = (),
        moe_aux_weight: float = 0.01,
        pos_encoding: str = "learned",
        num_kv_heads: int = 0,
        int8_kernel: str = "mm",
        tp=None,
    ):
        super().__init__()
        if moe_layers and len(moe_layers) != len(blocks):
            raise ValueError(
                f"{len(moe_layers)} moe_layers for {len(blocks)} blocks: one entry "
                "(a MoELayer or None) per block"
            )
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype={compute_dtype!r}; expected float32|bfloat16")
        if seq_mode not in _SEQ_MODES:
            raise ValueError(f"seq_mode={seq_mode!r}; expected local|ring|ulysses")
        if seq_mode != "local" and mesh is None:
            mesh = current_mesh()
            if mesh is None:
                raise ValueError(
                    f"seq_mode={seq_mode!r} needs a mesh: pass mesh=... or build "
                    "the model inside use_mesh(...)"
                )
        self.embed = _leaf(embed)
        self.pos_embed = _leaf(pos_embed)
        self.blocks = nn.ModuleList(blocks)
        self.num_heads = num_heads
        self.seq_mode = seq_mode
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.remat = remat
        self.remat_policy = remat_policy
        self.compute_dtype = compute_dtype
        # a tuple parallel to the blocks (None keeps the dense FFN); the
        # ModuleList registers the layers as submodules
        self.moe_layers = tuple(moe_layers)
        self.experts = nn.ModuleList([m for m in moe_layers if m is not None])
        self.moe_aux_weight = moe_aux_weight
        self.pos_encoding = pos_encoding
        self.num_kv_heads = num_kv_heads
        self.int8_kernel = int8_kernel
        # the tensor-parallel layout (models/lm/sharding.TensorParallel)
        self.tp = tp

    def replace(self, **changes) -> "TransformerLM":
        """A model sharing this one's tensors, with ``changes`` applied
        (the counterpart of ``dataclasses.replace``)."""
        kw = dict(
            embed=self.embed, pos_embed=self.pos_embed, blocks=list(self.blocks),
            num_heads=self.num_heads, seq_mode=self.seq_mode, mesh=self.mesh,
            seq_axis=self.seq_axis, remat=self.remat, remat_policy=self.remat_policy,
            compute_dtype=self.compute_dtype, moe_layers=self.moe_layers,
            moe_aux_weight=self.moe_aux_weight, pos_encoding=self.pos_encoding,
            num_kv_heads=self.num_kv_heads,
            int8_kernel=self.int8_kernel, tp=self.tp,
        )
        kw.update(changes)
        embed, pos_embed, blocks = kw.pop("embed"), kw.pop("pos_embed"), kw.pop("blocks")
        return TransformerLM(embed, pos_embed, blocks, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def _qkv_heads(self, x, blk: LMBlock, positions=None):
        """(q with H heads, k/v with KV heads, rope applied). ``positions``
        defaults to 0..S-1; decode passes its token's global position."""
        return self._qkv(x, blk.wq, blk.wk, blk.wv, self.num_heads, self.kv_heads, positions)

    def _qkv(self, x, wq, wk, wv, h: int, kvh: int, positions=None):
        mm_fn = model_mm(self)
        q = _split_heads(x, wq, h, mm_fn)
        k = _split_heads(x, wk, kvh, mm_fn)
        v = _split_heads(x, wv, kvh, mm_fn)
        if self.pos_encoding == "rope":
            if positions is None:
                positions = torch.arange(x.shape[1], device=x.device)
            q = _rope(q, positions)
            k = _rope(k, positions)
        return q, k, v

    def _attend(self, q, k, v):
        """Causal attention of (N, h, S, hd) queries over (N, kvh, S, hd)
        keys and values (broadcast to h heads) in the model's mode."""
        if k.shape[1] != q.shape[1]:
            g = q.shape[1] // k.shape[1]
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        if self.seq_mode == "ring":
            return ring_attention(
                q, k, v, self.mesh, seq_axis=self.seq_axis, causal=True, trainable=True
            )
        if self.seq_mode == "ulysses":
            return ulysses_attention(
                q, k, v, self.mesh, seq_axis=self.seq_axis, causal=True, trainable=True
            )
        if _use_flash(q):
            return flash_attention_trainable(
                q.contiguous(), k.contiguous(), v.contiguous(), True
            )
        return dense_attention(q, k, v, causal=True)

    def _attention(self, x, blk: LMBlock, return_kv: bool = False):
        n, s, d = x.shape
        if self.tp is not None and self.tp.attn:
            return self._attention_tp(x, blk, return_kv=return_kv)
        # x is the full sequence here: the sequence-parallel modes shard it
        # inside ring/ulysses_attention
        q, k, v = self._qkv_heads(x, blk)
        out = self._attend(q, k, v)
        proj = model_mm(self)(
            out.transpose(1, 2).reshape(n, s, d).to(x.dtype), blk.wo, x.dtype
        )
        if return_kv:
            return proj, (k, v)
        return proj

    def _attention_tp(self, x, blk: LMBlock, return_kv: bool = False, positions=None,
                      attend=None):
        """Head-parallel attention: each position of the model axis runs
        its H/n query heads and KV/n key/value heads (columns of wq, wk and
        wv) and its rows of wo; the partial projections add up over the
        axis. ``positions`` are the tokens' positions (decode passes its
        own); ``attend(pos, q, k, v)``, when given, attends position
        ``pos``'s heads (decode's cached attention), else the model's
        causal attention does. With ``return_kv`` the K/V heads of this
        process's positions come back joined along the head axis (every
        head in one process, the rank's own across processes)."""
        tp = self.tp
        n, s, d = x.shape
        h, kvh = self.num_heads // tp.n, self.kv_heads // tp.n
        mm_fn = model_mm(self)
        parts, ks, vs = [], [], []
        for pos, y in zip(tp.comm.positions, tp.comm.enter(x)):
            w = functools.partial(tp.part, pos=pos, device=y.device)
            q, k, v = self._qkv(y, w(blk.wq, 1), w(blk.wk, 1), w(blk.wv, 1), h, kvh, positions)
            out = self._attend(q, k, v) if attend is None else attend(pos, q, k, v)
            parts.append(mm_fn(out.transpose(1, 2).reshape(n, s, d // tp.n).to(y.dtype),
                               w(blk.wo, 0), y.dtype))
            ks.append(k)
            vs.append(v)
        proj = tp.comm.psum(parts, device=x.device)
        if return_kv:
            return proj, (tp.comm.join_local(ks, 1, x.device),
                          tp.comm.join_local(vs, 1, x.device))
        return proj

    def _ffn_tp(self, y, blk: LMBlock):
        """The MLP column-parallel then row-parallel over the model axis."""
        tp = self.tp
        mm_fn = model_mm(self)
        parts = [
            _mlp(yy, tp.part(blk.w1, 1, pos, yy.device), tp.part(blk.w2, 0, pos, yy.device),
                 self.cdt, mm_fn)
            for pos, yy in zip(tp.comm.positions, tp.comm.enter(y))
        ]
        return tp.comm.psum(parts, device=y.device)

    def logit_parts(self, x) -> list:
        """The tied logits of final hidden states x (B, S, d) as the
        model axis holds them: one (B, S, V/n) f32 block a position under
        a vocab-sharded ``tp``, else the whole (B, S, V) in a list."""
        tp = self.tp
        if tp is None or not tp.vocab:
            return [_tied_logits(x, self.embed, self.cdt)]
        a = _ln(x, self.cdt).to(torch.float32)
        return [
            _logits_of(aa, tp.part(self.embed, 0, pos, aa.device), self.cdt)
            for pos, aa in zip(tp.comm.positions, tp.comm.enter(a))
        ]

    def _moe(self, i: int):
        """Block ``i``'s expert layer (expert-parallel under a layout that
        splits the experts), or None."""
        moe = self.moe_layers[i] if self.moe_layers else None
        if moe is not None and self.tp is not None and self.tp.experts:
            return functools.partial(moe, tp=self.tp)
        return moe

    def _ffn(self):
        """The tensor-parallel MLP under a layout that splits it, else None
        (the block's own)."""
        return self._ffn_tp if self.tp is not None and self.tp.ffn else None

    def forward(self, tokens):
        """(B, S) int tokens → (B, S, V) float32 logits."""
        return self.forward_with_aux(tokens)[0]

    def backbone(self, tokens):
        """(final hidden states (B, S, d) before the logits, the MoE aux
        loss summed over the blocks: an f32 scalar, 0 without experts)."""
        cdt = self.cdt
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = _embed(self, tokens, cdt)
        mm_fn = model_mm(self)
        ffn = self._ffn()

        def block_fn(x, blk, moe):
            out, _, moe_aux = _block_apply(
                x, blk, cdt, lambda y, b: (self._attention(y, b), None), moe=moe,
                mm_fn=mm_fn, ffn=ffn,
            )
            return out, moe_aux

        if self.remat:
            block_fn = remat_wrap(block_fn, self.remat_policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, blk in enumerate(self.blocks):
            x, moe_aux = block_fn(x, blk, self._moe(i))
            if moe_aux is not None:
                aux = aux + moe_aux
        return x, aux

    def forward_with_aux(self, tokens):
        """(logits (B, S, V) f32, the total MoE load-balance aux loss).
        Vocab-sharded logits are gathered over the model axis."""
        x, aux = self.backbone(tokens)
        return self.logits(x), aux

    def logits(self, x):
        """The whole (B, S, V) f32 logits of final hidden states x."""
        parts = self.logit_parts(x)
        if self.tp is None or not self.tp.vocab:
            return parts[0]
        return self.tp.comm.gather(parts, -1, device=x.device)

    @staticmethod
    def create(
        vocab: int = 256,
        max_seq: int = 512,
        dim: int = 256,
        depth: int = 4,
        num_heads: int = 8,
        ff_mult: int = 4,
        seq_mode: str = "local",
        mesh=None,
        seq_axis: str = "data",
        compute_dtype: str = "float32",
        moe_every: int = 0,
        num_experts: int = 8,
        capacity_factor: float = 1.25,
        pos_encoding: str = "learned",
        num_kv_heads: int = 0,
        device=None,
        generator: torch.Generator | None = None,
    ) -> "TransformerLM":
        """A model with random weights drawn on ``device`` (the card unless
        the caller asks for the CPU) from ``generator`` (seed 0 when None).
        The weights follow the JAX package's recipe, not its bits.

        ``moe_every=k`` replaces the dense FFN of every k-th block with a
        top-2 routed :class:`MoELayer` of ``num_experts`` experts (0 =
        dense everywhere). The experts are drawn after every dense weight,
        and a MoE block's dense FFN is drawn and dropped, so the shared
        weights equal the dense model's, as the JAX package's folded-in
        MoE keys keep them."""
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding={pos_encoding!r}; expected learned|rope")
        if pos_encoding == "rope" and (dim // num_heads) % 2:
            raise ValueError(
                f"rope needs an even head dim; got dim/num_heads = "
                f"{dim}/{num_heads} = {dim // num_heads}"
            )
        kvh = num_kv_heads or num_heads
        if kvh <= 0 or num_heads % kvh:
            raise ValueError(
                f"num_heads={num_heads} not divisible by num_kv_heads={kvh}"
            )
        num_kv_heads = 0 if kvh == num_heads else kvh
        kv_dim = kvh * (dim // num_heads)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def normal(shape, std):
            return torch.randn(shape, generator=generator, device=dev) * std

        embed = normal((vocab, dim), 0.02)
        pos_embed = (
            torch.zeros((0, dim), device=dev)
            if pos_encoding == "rope"
            else normal((max_seq, dim), 0.02)
        )
        is_moe = [bool(moe_every) and (i + 1) % moe_every == 0 for i in range(depth)]
        blocks = []
        for i in range(depth):
            ws = dict(
                wq=normal((dim, dim), dim**-0.5),
                wk=normal((dim, kv_dim), dim**-0.5),
                wv=normal((dim, kv_dim), dim**-0.5),
                wo=normal((dim, dim), dim**-0.5),
                w1=normal((dim, ff_mult * dim), dim**-0.5),
                w2=normal((ff_mult * dim, dim), (ff_mult * dim) ** -0.5),
            )
            if is_moe[i]:
                # never applied: zero-width placeholders keep the leaves uniform
                ws["w1"] = torch.zeros((dim, 0), device=dev)
                ws["w2"] = torch.zeros((0, dim), device=dev)
            blocks.append(LMBlock(**ws))
        moes = [
            MoELayer.create(dim, ff_mult * dim, num_experts, capacity_factor,
                            generator=generator, device=dev)
            if m else None
            for m in is_moe
        ]
        return TransformerLM(
            embed, pos_embed, blocks, num_heads=num_heads, seq_mode=seq_mode,
            mesh=mesh, seq_axis=seq_axis, compute_dtype=compute_dtype, pos_encoding=pos_encoding,
            num_kv_heads=num_kv_heads, moe_layers=tuple(moes) if moe_every else (),
        )

    def leaves(self) -> list:
        """Every weight in the JAX package's leaf order: the embeddings,
        each block's six matrices, then each MoE layer's router, w1, w2."""
        out = [self.embed, self.pos_embed]
        for blk in self.blocks:
            out.extend(blk.leaves())
        for m in self.moe_layers:
            if m is not None:
                out.extend(m.leaves())
        return out

    def num_params(self) -> int:
        """Number of stored values, a QTensor's codes and scales both
        counted (as the JAX package counts its leaves); a model sharded
        across processes counts its whole leaves."""
        if self.tp is not None and self.tp.local:
            from keystone_tpu_torch.models.lm.sharding import whole_numel

            return whole_numel(self)
        total = 0
        for leaf in self.leaves():
            if isinstance(leaf, QTensor):
                total += leaf.q.numel() + leaf.scale.numel()
            else:
                total += leaf.numel()
        return total


# the weight products of a block: (B, S, d) @ (d, f) lowers to aten.mm
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``): keep the outputs of products
    without a batch dimension, recompute everything else — attention's
    batched products and K2 included."""
    if op in _WEIGHT_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, policy: str):
    """``fn`` rematerialized in the backward under the model's remat
    policy: "full" keeps only its inputs (``torch.utils.checkpoint``);
    "dots" also keeps its weight products (selective checkpointing).
    Outside autograd it is ``fn`` as it is."""
    if policy == "full":
        context_fn = noop_context_fn
    elif policy == "dots":
        context_fn = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products
        )
    else:
        raise ValueError(f"remat_policy={policy!r}; expected full|dots")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped


def has_quantized_leaves(model) -> bool:
    """True if any leaf is an int8 :class:`QTensor` (a serving model —
    training rejects it: gradients through the rounding would be 0)."""
    return any(isinstance(leaf, QTensor) for leaf in model.leaves())


def train_step_flops(model: TransformerLM, batch: int, seq: int) -> float:
    """Analytic FLOPs of one train step: 6·P_active·tokens for the matmul
    work plus the attention score and value terms (12·L·d·S²·B, forward
    and backward). The expert products run over all E·C static capacity
    slots, drops included, so expert parameters count at the slots' share
    of E·tokens (the JAX package's formula, C taken at the whole batch's
    token count)."""
    p = model.num_params()
    tokens = batch * seq
    for m in model.moe_layers:
        if m is not None:
            expert_p = m.w1.numel() + m.w2.numel()
            slots = m.num_experts * m._capacity(tokens)
            p -= expert_p * (1.0 - min(slots / (tokens * m.num_experts), 1.0))
    d = model.embed.shape[-1]
    attn = 12 * len(model.blocks) * d * seq * seq * batch
    return 6.0 * p * tokens + attn
