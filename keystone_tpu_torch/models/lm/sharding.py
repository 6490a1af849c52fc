"""Tensor-parallel weight layout for the transformer LM — port of
``keystone_tpu/models/lm/sharding.py``.

The JAX package lays each weight out over the mesh ``model`` axis and XLA
inserts the collectives ("the layout IS the parallelism"). Torch has no
such propagation: :func:`shard_params` records the layout on the model
(:class:`TensorParallel`) and the model's block writes its two collectives
by hand (:mod:`keystone_tpu_torch.models.lm.model`). The layout is the
reference's:

- ``wq``, ``wk``, ``wv`` and ``w1`` split by columns, ``wo`` and ``w2`` by
  rows; a MoE layer's ``w1`` and ``w2`` by expert with ``w_router`` whole;
  ``embed`` by vocab rows and ``pos_embed`` whole;
- a dim that does not split evenly over the axis stays whole (an unpadded
  vocab, 31 over 4, keeps the table and the logits whole);
- heads do not straddle shards: where ``num_heads`` or the KV heads do not
  split over the axis, the attention weights stay whole (the reference
  splits such columns and lets XLA move the straddling heads; the numbers
  are the same).

On a mesh whose model axis spans processes each rank keeps only its shard
of a split leaf; in one process the leaves stay whole and each position
takes its slice when it runs. :func:`unshard_params` is the inverse, for
checkpoints and tests.
"""

from __future__ import annotations

import dataclasses

import torch

from keystone_tpu_torch.models.lm.model import LMBlock, TransformerLM, has_quantized_leaves
from keystone_tpu_torch.parallel.collectives import AxisComm, all_gather_cat
from keystone_tpu_torch.parallel.mesh import MODEL_AXIS

_COLS, _ROWS = 1, 0


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """Which leaves a model splits over ``mesh``'s model axis: the
    attention (``attn``), the dense MLP (``ffn``), the embedding's vocab
    rows (``vocab``) and the MoE experts (``experts``)."""

    mesh: object
    attn: bool
    ffn: bool
    vocab: bool
    experts: bool
    comm: AxisComm = dataclasses.field(compare=False, repr=False)

    @property
    def n(self) -> int:
        return self.comm.n

    @property
    def local(self) -> bool:
        """True when the leaves hold this rank's shard (a model axis across
        processes), False when they are whole (one process)."""
        return self.comm.across

    def part(self, w, dim: int, pos: int, device):
        """Position ``pos``'s piece of a split leaf ``w`` along ``dim``, on
        ``device``."""
        if self.local:
            return w
        return w.tensor_split(self.n, dim=dim)[pos].to(device)


def _dense(blk) -> bool:
    return blk.w1.shape[1] > 0


def leaf_dims(model: TransformerLM) -> list:
    """The split dim of each leaf in ``model.leaves()`` order (None for a
    whole leaf) under the model's layout; all None without one."""
    tp = model.tp
    attn = tp is not None and tp.attn
    ffn = tp is not None and tp.ffn
    dims = [_ROWS if tp is not None and tp.vocab else None, None]
    for blk in model.blocks:
        # a MoE block's zero-width FFN placeholders split as the
        # reference's do (0 divides evenly)
        split = tp is not None and (ffn or not _dense(blk))
        dims += [_COLS if attn else None] * 3 + [_ROWS if attn else None]
        dims += [_COLS if split else None, _ROWS if split else None]
    for m in model.moe_layers:
        if m is not None:
            split = tp is not None and tp.experts
            dims += [None] + [0 if split else None] * 2
    return dims


def leaf_specs(model: TransformerLM) -> list:
    """Each leaf's partition spec, one entry per dim (``"model"`` on the
    split dim, else None) — the port's counterpart of
    ``leaf.sharding.spec``."""
    return [
        tuple(MODEL_AXIS if i == dim else None for i in range(leaf.ndim))
        for leaf, dim in zip(model.leaves(), leaf_dims(model))
    ]


def whole_shapes(model: TransformerLM) -> list:
    """Each leaf's shape as the whole model holds it."""
    n = model.tp.n if model.tp is not None and model.tp.local else 1
    out = []
    for leaf, dim in zip(model.leaves(), leaf_dims(model)):
        shape = list(leaf.shape)
        if dim is not None:
            shape[dim] *= n
        out.append(shape)
    return out


def _layout(model: TransformerLM, mesh, comm: AxisComm) -> TensorParallel:
    n = comm.n
    dense = [b for b in model.blocks if _dense(b)]
    experts = [m for m in model.moe_layers if m is not None]
    return TensorParallel(
        mesh=mesh,
        attn=model.num_heads % n == 0 and model.kv_heads % n == 0,
        ffn=bool(dense) and all(b.w1.shape[1] % n == 0 for b in dense),
        vocab=model.embed.shape[0] % n == 0,
        experts=bool(experts) and all(m.num_experts % n == 0 for m in experts),
        comm=comm,
    )


def shard_params(model: TransformerLM, mesh) -> TransformerLM:
    """Lay the weights out for tensor parallelism over the mesh ``model``
    axis (see the module docstring): the identity with no mesh or a model
    axis of one position. Across processes the returned model holds this
    rank's shards (taken from the whole model every rank passes in); in
    one process it shares ``model``'s whole tensors."""
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) == 1:
        return model
    if model.tp is not None:
        raise ValueError("the model is already sharded; unshard_params first")
    if has_quantized_leaves(model):
        raise NotImplementedError(
            "shard_params of int8 QTensor weights: serving a sharded model is "
            "ROADMAP A6 part 3"
        )
    comm = AxisComm.of(mesh, MODEL_AXIS)
    tp = _layout(model, mesh, comm)
    if not tp.local:
        return model.replace(tp=tp)
    pos = comm.positions[0]

    def mine(w, dim):
        if dim is None:
            return w
        return w.detach().tensor_split(tp.n, dim=dim)[pos].clone()

    sharded = model.replace(tp=tp)
    return _with_leaves(model, [mine(w, d) for w, d in zip(model.leaves(), leaf_dims(sharded))],
                        tp)


def _with_leaves(model: TransformerLM, leaves: list, tp) -> TransformerLM:
    """``model`` with its leaves (in ``leaves()`` order) replaced."""
    it = iter(leaves)
    embed, pos_embed = next(it), next(it)
    blocks = [LMBlock(*(next(it) for _ in range(6))) for _ in model.blocks]
    moes = tuple(
        None if m is None else m.replace(w_router=next(it), w1=next(it), w2=next(it))
        for m in model.moe_layers
    )
    return model.replace(embed=embed, pos_embed=pos_embed, blocks=blocks, moe_layers=moes,
                         tp=tp)


def gather_leaf(model: TransformerLM, leaf: torch.Tensor, dim) -> torch.Tensor:
    """The whole value of one of ``model``'s leaves (or of a tensor laid
    out like it, as an optimizer moment): gathered over the model axis
    when it is split across processes, else ``leaf`` itself."""
    tp = model.tp
    if dim is None or tp is None or not tp.local:
        return leaf
    return all_gather_cat(leaf.detach(), tp.comm.group, dim)


def local_leaf(model: TransformerLM, whole: torch.Tensor, dim) -> torch.Tensor:
    """This rank's shard of a whole value laid out like a leaf (the
    inverse of :func:`gather_leaf`)."""
    tp = model.tp
    if dim is None or tp is None or not tp.local:
        return whole
    return whole.tensor_split(tp.n, dim=dim)[tp.comm.positions[0]]


def unshard_params(model: TransformerLM) -> TransformerLM:
    """The whole model from a sharded one: leaves gathered over the model
    axis across processes (every rank of the axis must call it), the
    layout dropped in one process."""
    if model.tp is None:
        return model
    if not model.tp.local:
        return model.replace(tp=None)
    whole = [gather_leaf(model, w, d) for w, d in zip(model.leaves(), leaf_dims(model))]
    return _with_leaves(model, whole, None)
