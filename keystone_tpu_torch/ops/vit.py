"""ViT-style patch-embedding featurizer — port of ``keystone_tpu/ops/vit.py``.

A frozen, randomly initialized transformer encoder as a featurizer for the
ridge solver: patches → embedding → pre-LN blocks → mean pool. The
attention is non-causal: kernel K2 (:func:`flash_attention`) on a CUDA
tensor, dense attention on a CPU one — the counterpart of the JAX
package's ``_flash_default()`` — and the ring (:func:`ring_attention`,
kernel K3 on a card mesh) when the featurizer holds a mesh.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from keystone_tpu_torch.core.pipeline import Transformer
from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.ops.attention import dense_attention, ring_attention
from keystone_tpu_torch.ops.flash_attention import flash_attention
from keystone_tpu_torch.ops.images import extract_patches


def _layer_norm(x, eps: float = 1e-6):
    """No affine, eps inside the rsqrt, the population variance
    (``jnp.var``)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


@dataclasses.dataclass(eq=False)
class ViTBlock:
    """One encoder block: wq, wk, wv, wo (d, d), w1 (d, 4d), w2 (4d, d)."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    num_heads: int = 4


@dataclasses.dataclass(eq=False)
class ViTFeaturizer(Transformer):
    """(N, H, W, C) images → (N, dim) pooled encoder features."""

    patch_embed: torch.Tensor  # (P²·C, dim)
    pos_embed: torch.Tensor  # (num_patches, dim)
    blocks: tuple  # of ViTBlock
    patch_size: int = 8
    mesh: object = None  # sequence-parallel when set
    seq_axis: str = "data"

    def __call__(self, batch):
        n = batch.shape[0]
        p = extract_patches(batch, self.patch_size, self.patch_size)
        x = p.reshape(n, -1, p.shape[-1]) @ self.patch_embed  # (N, S, dim)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = x + self._attention(_layer_norm(x), blk)
            h = _layer_norm(x) @ blk.w1
            x = x + F.gelu(h, approximate="tanh") @ blk.w2
        return torch.mean(_layer_norm(x), dim=1)  # (N, dim)

    def _attention(self, x, blk: ViTBlock):
        n, s, d = x.shape
        heads = blk.num_heads
        hd = d // heads

        def split(w):
            return (x @ w).reshape(n, s, heads, hd).transpose(1, 2).contiguous()

        q, k, v = split(blk.wq), split(blk.wk), split(blk.wv)
        if self.mesh is not None:
            out = ring_attention(q, k, v, self.mesh, seq_axis=self.seq_axis)
        elif x.device.type == "cuda":
            out = flash_attention(q, k, v)
        else:
            out = dense_attention(q, k, v)
        out = out.transpose(1, 2).reshape(n, s, d)
        return out @ blk.wo

    @staticmethod
    def create(
        image_size: int = 32,
        patch_size: int = 8,
        dim: int = 128,
        depth: int = 4,
        num_heads: int = 4,
        channels: int = 3,
        mesh=None,
        seq_axis: str = "data",
        *,
        generator: torch.Generator | None = None,
        device=None,
    ) -> "ViTFeaturizer":
        """Random weights drawn on ``device`` (the card unless the caller
        asks for the CPU) from ``generator`` (seed 0 when None), by the JAX
        package's recipe, not its bits: N(0, 1/fan_in) matrices and an
        N(0, 0.02²) position table."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        num_patches = (image_size // patch_size) ** 2
        pd = patch_size * patch_size * channels

        def init(shape, fan_in):
            return torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)

        patch_embed = init((pd, dim), pd)
        pos_embed = 0.02 * torch.randn((num_patches, dim), generator=generator, device=dev)
        blocks = tuple(
            ViTBlock(
                wq=init((dim, dim), dim),
                wk=init((dim, dim), dim),
                wv=init((dim, dim), dim),
                wo=init((dim, dim), dim),
                w1=init((dim, 4 * dim), dim),
                w2=init((4 * dim, dim), 4 * dim),
                num_heads=num_heads,
            )
            for _ in range(depth)
        )
        return ViTFeaturizer(
            patch_embed=patch_embed, pos_embed=pos_embed, blocks=blocks,
            patch_size=patch_size, mesh=mesh, seq_axis=seq_axis,
        )
