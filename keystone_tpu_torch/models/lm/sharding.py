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

Int8 serving quantizes after sharding, as the JAX package does
(``quantize_for_decode(shard_params(...))``): an int8 :class:`QTensor`
splits its codes along the leaf's dim and its scale with them where the
scale runs along that dim (a column piece's (1, N/n), an embedding vocab
piece's (V/n, 1)); a row piece of ``wo``/``w2`` keeps the whole (1, N)
scale, which pulls out of the partial sums exactly. A column piece of the
codes is a strided view, and K4 takes contiguous codes, so in one process
each position's pieces of a QTensor are made contiguous once, when the
sharded model is quantized (:meth:`TensorParallel.with_pieces`), and kept
on the layout. Sharding a model that already holds int8 leaves raises
``ValueError``, as the JAX package's ``device_put`` of a (1, N) scale
over the model axis does.
"""

from __future__ import annotations

import dataclasses
import math

from keystone_tpu_torch.models.lm.model import LMBlock, TransformerLM, has_quantized_leaves
from keystone_tpu_torch.ops.quantization import QTensor
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
    # id of a whole QTensor leaf -> (the leaf, its contiguous piece a
    # position), in one process (see with_pieces)
    pieces: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

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
        ``device``: a view of a float leaf, the piece made by
        :meth:`with_pieces` of a QTensor."""
        if self.local:
            return w
        if isinstance(w, QTensor):
            held = self.pieces.get(id(w))
            if held is None or held[0] is not w:
                raise ValueError(
                    "an int8 leaf of a sharded model without its pieces: quantize "
                    "through quantize_for_decode(shard_params(...))"
                )
            return held[1][pos]
        return w.tensor_split(self.n, dim=dim)[pos].to(device)

    def with_pieces(self, leaves, dims) -> "TensorParallel":
        """This layout holding, for every split QTensor of ``leaves`` (with
        their split ``dims``), each position's contiguous piece on its
        device: made once here, not on every call. Across processes the
        leaves are already the rank's pieces and nothing is made."""
        if self.local:
            return self
        pieces = {}
        for w, dim in zip(leaves, dims):
            if dim is not None and isinstance(w, QTensor):
                pieces[id(w)] = (w, [
                    QTensor(q.to(d).contiguous(), s.to(d).contiguous())
                    for q, s, d in zip(w.q.tensor_split(self.n, dim=dim),
                                       _scale_pieces(w, dim, self.n), self.comm.devices)
                ])
        return dataclasses.replace(self, pieces=pieces)


def _scale_splits(w: QTensor, dim: int) -> bool:
    """True when a QTensor's scale runs along ``dim`` and splits with its
    codes; a row piece of a (1, N)-scaled ``wo``/``w2`` keeps it whole."""
    return w.scale.shape[dim] == w.q.shape[dim]


def _scale_pieces(w: QTensor, dim: int, n: int) -> list:
    if _scale_splits(w, dim):
        return list(w.scale.tensor_split(n, dim=dim))
    return [w.scale] * n


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
    """Each leaf's shape as the whole model holds it (a QTensor's codes')."""
    return [shape for shape, _ in _whole_shapes(model)]


def whole_numel(model: TransformerLM) -> int:
    """The stored values of the whole model, a QTensor's codes and scales
    both counted, as the JAX package counts its leaves' global sizes."""
    return sum(math.prod(q) + (math.prod(s) if s else 0) for q, s in _whole_shapes(model))


def _whole_shapes(model: TransformerLM) -> list:
    """(shape, scale shape or None) of each leaf as the whole model holds
    it."""
    n = model.tp.n if model.tp is not None and model.tp.local else 1
    out = []
    for leaf, dim in zip(model.leaves(), leaf_dims(model)):
        shape = list(leaf.shape)
        scale = list(leaf.scale.shape) if isinstance(leaf, QTensor) else None
        if dim is not None:
            shape[dim] *= n
            if scale is not None and _scale_splits(leaf, dim):
                scale[dim] *= n
        out.append((shape, scale))
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
        raise ValueError(
            "shard_params of int8 weights: a (1, N) scale of a row-split wo/w2 does "
            "not split over the model axis; quantize after sharding, "
            "quantize_for_decode(shard_params(model, mesh))"
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


def gather_leaf(model: TransformerLM, leaf, dim):
    """The whole value of one of ``model``'s leaves (or of a tensor laid
    out like it, as an optimizer moment): gathered over the model axis
    when it is split across processes, else ``leaf`` itself. A QTensor
    gathers its codes, and its scale where the scale splits."""
    tp = model.tp
    if dim is None or tp is None or not tp.local:
        return leaf
    if isinstance(leaf, QTensor):
        scale = leaf.scale
        if _scale_splits(leaf, dim):
            scale = all_gather_cat(scale, tp.comm.group, dim)
        return QTensor(all_gather_cat(leaf.q, tp.comm.group, dim), scale)
    return all_gather_cat(leaf.detach(), tp.comm.group, dim)


def local_leaf(model: TransformerLM, whole, dim):
    """This rank's shard of a whole value laid out like a leaf (the
    inverse of :func:`gather_leaf`)."""
    tp = model.tp
    if dim is None or tp is None or not tp.local:
        return whole
    pos = tp.comm.positions[0]
    if isinstance(whole, QTensor):
        return QTensor(whole.q.tensor_split(tp.n, dim=dim)[pos],
                       _scale_pieces(whole, dim, tp.n)[pos])
    return whole.tensor_split(tp.n, dim=dim)[pos]


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
