"""Build the port's objects from the JAX package's parameters.

The JAX package draws its random signs and cosine features with
``jax.random``, which no torch seed reproduces; to run the two packages on
the same model, its parameters are carried across as numpy arrays, never
drawn again. Nothing here imports JAX:
the caller hands over plain arrays (``np.asarray`` of each leaf). Every
helper puts its tensors on ``device``: the card unless the caller asks for
the CPU.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from keystone_tpu_torch.core.runtime import resolve_device
from keystone_tpu_torch.models.lm.model import LMBlock, TransformerLM
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.models.mnist_random_fft import FeaturizerBank
from keystone_tpu_torch.models.timit_pipeline import ScaledCosineBank
from keystone_tpu_torch.ops.gmm import GaussianMixtureModel
from keystone_tpu_torch.ops.images import Convolver, FusedConvRectifyPool
from keystone_tpu_torch.ops.linalg import BatchPCATransformer, PCATransformer, ZCAWhitener
from keystone_tpu_torch.ops.linear import BlockLinearMapper, LinearMapper, NormalEqState
from keystone_tpu_torch.ops.naive_bayes import NaiveBayesModel
from keystone_tpu_torch.ops.moe import MoELayer
from keystone_tpu_torch.ops.vit import ViTBlock, ViTFeaturizer
from keystone_tpu_torch.ops.weighted_linear import WeightedEqState
from keystone_tpu_torch.ops.quantization import QTensor
from keystone_tpu_torch.ops.stats import (
    CosineRandomFeatures,
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
    StandardScalerModel,
)


def _t(x, device) -> torch.Tensor:
    """A float32 copy of ``x`` on ``device`` (JAX hands out read-only
    host views, so the port always takes its own copy)."""
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def featurizer_bank(
    signs: Sequence[Sequence[np.ndarray]],
    *,
    device: torch.device | str | None = None,
    impl: str = "auto",
) -> FeaturizerBank:
    """A :class:`FeaturizerBank` from per-batch, per-chain ``signs`` (the
    ``RandomSignNode.signs`` of each chain of the JAX bank's batches)."""
    device = resolve_device(device)
    return FeaturizerBank(
        batches=tuple(
            tuple(
                RandomSignNode(signs=_t(s, device))
                >> PaddedFFT(impl=impl)
                >> LinearRectifier()
                for s in batch
            )
            for batch in signs
        )
    )


def _scaler(mean, std, device) -> StandardScalerModel:
    return StandardScalerModel(
        mean=_t(mean, device), std=None if std is None else _t(std, device)
    )


def scaled_cosine_bank(
    chains: Sequence[Mapping], *, device: torch.device | str | None = None
) -> ScaledCosineBank:
    """A TIMIT :class:`ScaledCosineBank` from each chain's leaves: the
    cosine features' ``w`` and ``b`` and the fitted scaler's ``mean`` and
    ``std`` (``std`` None for a centering-only scaler)."""
    device = resolve_device(device)
    return ScaledCosineBank(
        chains=tuple(
            Pipeline.of(
                CosineRandomFeatures(w=_t(c["w"], device), b=_t(c["b"], device)),
                _scaler(c["mean"], c.get("std"), device),
            )
            for c in chains
        )
    )


def linear_mapper(
    x: np.ndarray,
    b: np.ndarray | None = None,
    mean: np.ndarray | None = None,
    std: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
) -> LinearMapper:
    """A :class:`LinearMapper` from its weights, intercept and feature
    scaler's ``mean`` and ``std`` (no scaler when ``mean`` is None)."""
    device = resolve_device(device)
    return LinearMapper(
        x=_t(x, device),
        b=None if b is None else _t(b, device),
        feature_scaler=None if mean is None else _scaler(mean, std, device),
    )


def block_linear_mapper(
    xs: Sequence[np.ndarray],
    b: np.ndarray | None,
    means: Sequence[np.ndarray] | None,
    *,
    block_size: int = 4096,
    device: torch.device | str | None = None,
) -> BlockLinearMapper:
    """A :class:`BlockLinearMapper` from per-block weights, intercept and
    per-block feature means."""
    device = resolve_device(device)
    return BlockLinearMapper(
        xs=tuple(_t(x, device) for x in xs),
        b=None if b is None else _t(b, device),
        means=None if means is None else tuple(_t(m, device) for m in means),
        block_size=block_size,
    )


def normal_eq_state(
    ata, atb, mean_a, mean_b, n, *, device: torch.device | str | None = None
) -> NormalEqState:
    """A :class:`NormalEqState` from the accumulated statistics."""
    device = resolve_device(device)
    return NormalEqState(
        ata=_t(ata, device),
        atb=_t(atb, device),
        mean_a=_t(mean_a, device),
        mean_b=_t(mean_b, device),
        n=_t(n, device),
    )


def block_weighted_mapper(
    xs: Sequence[np.ndarray],
    b: np.ndarray,
    *,
    block_size: int = 4096,
    device: torch.device | str | None = None,
) -> BlockLinearMapper:
    """The :class:`BlockLinearMapper` a weighted fit returns, from its
    per-block weights and (C,) intercept (it carries no feature means)."""
    return block_linear_mapper(xs, b, None, block_size=block_size, device=device)


def weighted_eq_state(
    ata, at_labels, class_ata, class_sum, sum_a, n_c, n, *,
    device: torch.device | str | None = None,
) -> WeightedEqState:
    """A :class:`WeightedEqState` from the accumulated per-class
    statistics, leaf for leaf."""
    device = resolve_device(device)
    return WeightedEqState(
        ata=_t(ata, device),
        at_labels=_t(at_labels, device),
        class_ata=_t(class_ata, device),
        class_sum=_t(class_sum, device),
        sum_a=_t(sum_a, device),
        n_c=_t(n_c, device),
        n=_t(n, device),
    )


# the JAX package names its int8 matmul routes by backend; the port names
# what runs
_INT8_KERNEL = {"xla": "mm", "pallas": "kernel"}


def _lm_leaf(x, device):
    """A float leaf as an f32 tensor; a leaf with ``q`` and ``scale``
    (the JAX package's QTensor) as the port's :class:`QTensor`."""
    if hasattr(x, "q") and hasattr(x, "scale"):
        return QTensor(
            q=torch.tensor(np.asarray(x.q), dtype=torch.int8, device=device),
            scale=_t(x.scale, device),
        )
    return _t(x, device)


def moe_layer(leaves: Mapping, *, device: torch.device | str | None = None) -> MoELayer:
    """A :class:`MoELayer` from the JAX layer's ``w_router`` (d, E), ``w1``
    (E, d, ff) and ``w2`` (E, ff, d), with its ``capacity_factor`` and
    ``group_size`` when the mapping holds them."""
    device = resolve_device(device)
    return MoELayer(
        _t(leaves["w_router"], device),
        _t(leaves["w1"], device),
        _t(leaves["w2"], device),
        capacity_factor=leaves.get("capacity_factor", 1.25),
        group_size=leaves.get("group_size", 4096),
    )


def transformer_lm(
    leaves: Mapping,
    *,
    num_heads: int,
    num_kv_heads: int = 0,
    pos_encoding: str = "learned",
    compute_dtype: str = "float32",
    int8_kernel: str = "xla",
    seq_mode: str = "local",
    mesh=None,
    seq_axis: str = "data",
    remat: bool = False,
    remat_policy: str = "full",
    moe_aux_weight: float = 0.01,
    device: torch.device | str | None = None,
) -> TransformerLM:
    """A :class:`TransformerLM` from the JAX model's leaves: ``{"embed",
    "pos_embed", "blocks": [{"wq", "wk", "wv", "wo", "w1", "w2"}, ...]}``,
    each an array or a QTensor-like leaf, and, for a MoE model,
    ``"moe_layers"``: one entry per block, None or a mapping for
    :func:`moe_layer` (a MoE block's ``w1``/``w2`` are its zero-width
    placeholders). ``int8_kernel`` takes the JAX package's names: "xla" →
    "mm", "pallas" → "kernel". ``seq_mode``, ``mesh`` (a port
    :class:`~keystone_tpu_torch.parallel.Mesh`), ``seq_axis``, ``remat``,
    ``remat_policy`` and ``moe_aux_weight`` are the model's own."""
    if int8_kernel not in _INT8_KERNEL:
        raise ValueError(f"int8_kernel={int8_kernel!r}; expected xla|pallas")
    device = resolve_device(device)
    blocks = [
        LMBlock(*(_lm_leaf(b[n], device) for n in ("wq", "wk", "wv", "wo", "w1", "w2")))
        for b in leaves["blocks"]
    ]
    moes = tuple(
        None if m is None else moe_layer(m, device=device) for m in leaves.get("moe_layers", ())
    )
    return TransformerLM(
        _lm_leaf(leaves["embed"], device),
        _lm_leaf(leaves["pos_embed"], device),
        blocks,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        pos_encoding=pos_encoding,
        compute_dtype=compute_dtype,
        int8_kernel=_INT8_KERNEL[int8_kernel],
        seq_mode=seq_mode,
        mesh=mesh,
        seq_axis=seq_axis,
        remat=remat,
        remat_policy=remat_policy,
        moe_layers=moes,
        moe_aux_weight=moe_aux_weight,
    )


def vit_featurizer(
    leaves: Mapping,
    *,
    patch_size: int = 8,
    num_heads: int = 4,
    mesh=None,
    seq_axis: str = "data",
    device: torch.device | str | None = None,
) -> ViTFeaturizer:
    """A :class:`ViTFeaturizer` from the JAX featurizer's leaves:
    ``{"patch_embed", "pos_embed", "blocks": [{"wq", "wk", "wv", "wo",
    "w1", "w2"}, ...]}``. ``mesh`` (a port
    :class:`~keystone_tpu_torch.parallel.Mesh`) runs the attention as the
    ring."""
    device = resolve_device(device)
    blocks = tuple(
        ViTBlock(**{n: _t(b[n], device) for n in ("wq", "wk", "wv", "wo", "w1", "w2")},
                 num_heads=num_heads)
        for b in leaves["blocks"]
    )
    return ViTFeaturizer(
        patch_embed=_t(leaves["patch_embed"], device),
        pos_embed=_t(leaves["pos_embed"], device),
        blocks=blocks,
        patch_size=patch_size,
        mesh=mesh,
        seq_axis=seq_axis,
    )


def convolver(
    filters: np.ndarray,
    whitener_means: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
    **options,
) -> Convolver:
    """A :class:`Convolver` from its filter bank (F, k²C) and whitener
    means; ``options`` are the JAX node's other fields (``patch_size``,
    ``normalize_patches``, ``var_constant``, ``impl``, ``precision``)."""
    device = resolve_device(device)
    return Convolver(
        filters=_t(filters, device),
        whitener_means=None if whitener_means is None else _t(whitener_means, device),
        **options,
    )


def fused_conv_rectify_pool(
    filters: np.ndarray,
    whitener_means: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
    **options,
) -> FusedConvRectifyPool:
    """A :class:`FusedConvRectifyPool` from its filter bank and whitener
    means; ``options`` are the JAX node's other fields (``patch_size``,
    ``alpha``, ``pool_stride``, ``pool_size``, ``pool_fn``, ``impl``, ...)."""
    device = resolve_device(device)
    return FusedConvRectifyPool(
        filters=_t(filters, device),
        whitener_means=None if whitener_means is None else _t(whitener_means, device),
        **options,
    )


def zca_whitener(
    whitener: np.ndarray, means: np.ndarray, *, device: torch.device | str | None = None
) -> ZCAWhitener:
    """A :class:`ZCAWhitener` from its (d, d) matrix and (d,) means."""
    device = resolve_device(device)
    return ZCAWhitener(whitener=_t(whitener, device), means=_t(means, device))


def pca_transformer(
    pca_mat: np.ndarray, *, batch: bool = False, device: torch.device | str | None = None
) -> PCATransformer | BatchPCATransformer:
    """A :class:`PCATransformer` (or, with ``batch``, the descriptor-matrix
    :class:`BatchPCATransformer`) from its (d, dims) matrix."""
    device = resolve_device(device)
    cls = BatchPCATransformer if batch else PCATransformer
    return cls(pca_mat=_t(pca_mat, device))


def naive_bayes_model(
    log_pi: np.ndarray, log_theta: np.ndarray, *, device: torch.device | str | None = None
) -> NaiveBayesModel:
    """A :class:`NaiveBayesModel` from its (C,) log priors and (C, D) log
    likelihoods."""
    device = resolve_device(device)
    return NaiveBayesModel(log_pi=_t(log_pi, device), log_theta=_t(log_theta, device))


def gmm(
    means: np.ndarray,
    variances: np.ndarray,
    weights: np.ndarray,
    *,
    device: torch.device | str | None = None,
) -> GaussianMixtureModel:
    """A :class:`GaussianMixtureModel` from its (dim, k) means and
    variances and (k,) weights."""
    device = resolve_device(device)
    return GaussianMixtureModel(
        means=_t(means, device), variances=_t(variances, device), weights=_t(weights, device)
    )


def pca_matrix(mat: np.ndarray, *, device: torch.device | str | None = None) -> torch.Tensor:
    """A (d, dims) PCA matrix (``compute_pca``'s output, the
    ``BatchPCATransformer``'s ``pca_mat``) as a float32 tensor."""
    return _t(mat, resolve_device(device))
