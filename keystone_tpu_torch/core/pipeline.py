"""The pipeline DSL — port of ``keystone_tpu/core/pipeline.py``.

KeystoneML's four-role pipeline algebra over batches of tensors:

- :class:`Transformer` — a deterministic function over a *batch* (leading
  axis = items), composed with ``a >> b`` (or ``a.then(b)``) into a
  :class:`Pipeline`;
- :class:`Estimator` — ``fit(data) -> Transformer``;
- :class:`LabelEstimator` — ``fit(data, labels) -> Transformer``;
- :class:`FunctionNode` — whole-dataset operations that are not row-wise.

Chaining an estimator onto a transformer yields a :class:`ChainedEstimator`
(or :class:`ChainedLabelEstimator`) whose ``fit`` featurizes with the
prefix first; chaining a transformer onto an estimator defers it behind
the fitted model. Nodes are plain dataclasses holding tensors; there is no
``jit`` boundary, everything runs eagerly on the tensors' own device.

Resilience hooks, as in the JAX package: the opt-in output guard
(``KEYSTONE_GUARD_OUTPUTS``, :mod:`keystone_tpu_torch.resilience.guards`)
checks each node's result for non-finite values, and a chained fit's
entry carries the ``batch.nan`` and ``accel.fit`` fault sites. With the
guard off and no fault plan, ``apply`` and ``fit`` read one flag each and
do nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from keystone_tpu_torch.core.runtime import synchronize
from keystone_tpu_torch.resilience import faults as _faults
from keystone_tpu_torch.resilience import guards as _guards


def node_label(node: Any, index: int | None = None) -> str:
    """Stable display label for a pipeline node (plan decisions key on
    it); the index prefix keeps two like-typed nodes apart."""
    name = getattr(node, "name", None)
    if not name or not isinstance(name, str):
        name = type(node).__name__
    return f"{index:02d}:{name}" if index is not None else name


class _Chainable:
    """Mixin providing ``then`` / ``>>`` composition dispatch."""

    def then(self, nxt):
        """Compose this node with the next stage: a Transformer gives a
        :class:`Pipeline`, an Estimator a :class:`ChainedEstimator`, a
        LabelEstimator a :class:`ChainedLabelEstimator`, a bare callable is
        lifted via :func:`transformer`."""
        if isinstance(nxt, LabelEstimator):
            return ChainedLabelEstimator(prefix=_as_transformer(self), est=nxt)
        if isinstance(nxt, Estimator):
            return ChainedEstimator(prefix=_as_transformer(self), est=nxt)
        if isinstance(nxt, Transformer):
            return Pipeline.of(_as_transformer(self), nxt)
        if callable(nxt):
            return Pipeline.of(_as_transformer(self), transformer(nxt))
        raise TypeError(f"cannot chain {type(nxt).__name__} onto a pipeline")

    def __rshift__(self, nxt):
        return self.then(nxt)


class Transformer(_Chainable):
    """A pure, deterministic function over a batch of items."""

    def __call__(self, batch):
        raise NotImplementedError

    def apply(self, batch):
        return self(batch)


@dataclasses.dataclass(eq=False)
class FnTransformer(Transformer):
    """A Transformer lifted from a bare batch function."""

    fn: Callable[[Any], Any]
    name: str = "fn"

    def __call__(self, batch):
        return self.fn(batch)

    def __repr__(self):
        return f"FnTransformer({self.name})"


def transformer(fn: Callable[[Any], Any], name: str | None = None) -> Transformer:
    """Lift a batch function into a :class:`Transformer`."""
    if isinstance(fn, Transformer):
        return fn
    return FnTransformer(fn=fn, name=name or getattr(fn, "__name__", "fn"))


@dataclasses.dataclass(eq=False)
class BoundTransformer(Transformer):
    """A lifted ``fn(params, batch)`` that carries its fitted ``params``
    as a field instead of closing over them."""

    params: Any
    fn: Callable[[Any, Any], Any]
    name: str = "bound"

    def __call__(self, batch):
        return self.fn(self.params, batch)

    def __repr__(self):
        return f"BoundTransformer({self.name})"


def bind(fn: Callable[[Any, Any], Any], params: Any, name: str | None = None) -> Transformer:
    """Lift ``fn(params, batch)`` with ``params`` carried by the node."""
    return BoundTransformer(params=params, fn=fn, name=name or getattr(fn, "__name__", "bound"))


@dataclasses.dataclass(eq=False)
class Pipeline(Transformer):
    """A flat chain of transformers applied in sequence."""

    nodes: tuple = ()

    @staticmethod
    def of(*nodes) -> "Pipeline":
        flat: list[Transformer] = []
        for n in nodes:
            if isinstance(n, Pipeline):
                flat.extend(n.nodes)
            elif isinstance(n, Transformer):
                flat.append(n)
            elif callable(n):
                flat.append(transformer(n))
            else:
                raise TypeError(f"not a pipeline node: {n!r}")
        return Pipeline(nodes=tuple(flat))

    def __call__(self, batch):
        # one flag read when the output guard is off: no per-node work
        if not _guards.output_guard_mode():
            for node in self.nodes:
                batch = node(batch)
            return batch
        return self._call_guarded(batch)

    def _call_guarded(self, batch):
        """Apply with the opt-in output guard: each node's result is
        checked for non-finite values (a device sync per node — the
        reason the guard is opt-in)."""
        for i, node in enumerate(self.nodes):
            batch = node(batch)
            _guards.check_finite(node_label(node, i), batch, "apply")
        return batch

    def __iter__(self):
        return iter(self.nodes)

    def __len__(self):
        return len(self.nodes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Pipeline(nodes=self.nodes[i])
        return self.nodes[i]

    def __repr__(self):
        inner = " >> ".join(type(n).__name__ for n in self.nodes)
        return f"Pipeline({inner})"


def _fit_entry(data):
    """Resilience hooks at a chained fit's entry: the ``batch.nan`` site
    poisons a float batch's first row, ``accel.fit`` drops the
    "accelerator" (raises the UNAVAILABLE-shaped error a lost device
    produces). One global read when no faults are configured."""
    if _faults.active() is None:
        return data
    data = _faults.poison("batch.nan", data)
    _faults.maybe_drop_accelerator()
    return data


def _guard_feats(name: str, feats) -> None:
    """Opt-in non-finite check on the featurized fit input (the output
    guard's fit-path hook)."""
    if _guards.output_guard_mode():
        _guards.check_finite(name, feats, "fit")


class Estimator:
    """Unsupervised estimator: ``fit(data) -> Transformer``; ``est.then(t)``
    defers ``t`` behind the fitted model."""

    def fit(self, data, **kw) -> Transformer:
        raise NotImplementedError

    def fit_pipeline(self, data, **kw) -> "Pipeline":
        """Fit and wrap the result as a single-node pipeline."""
        return Pipeline.of(self.fit(data, **kw))

    def then(self, nxt) -> "Estimator":
        return _SuffixedEstimator(est=self, suffix=_as_transformer(nxt))

    def __rshift__(self, nxt):
        return self.then(nxt)


class LabelEstimator:
    """Supervised estimator: ``fit(data, labels) -> Transformer``.

    ``fits_global_rows`` says whether :meth:`fit` takes a global batch (a
    :class:`~keystone_tpu_torch.parallel.multihost.GlobalRows`: this
    process's row block of rows spread over processes) and fits every
    process's rows; an estimator without that branch would read the block
    as the whole batch."""

    fits_global_rows = False

    def fit(self, data, labels, **kw) -> Transformer:
        raise NotImplementedError

    def then(self, nxt) -> "LabelEstimator":
        return _SuffixedLabelEstimator(est=self, suffix=_as_transformer(nxt))

    def __rshift__(self, nxt):
        return self.then(nxt)


@dataclasses.dataclass(eq=False)
class FnEstimator(Estimator):
    fn: Callable[..., Transformer]

    def fit(self, data, **kw) -> Transformer:
        return self.fn(data, **kw)


@dataclasses.dataclass(eq=False)
class FnLabelEstimator(LabelEstimator):
    fn: Callable[..., Transformer]

    def fit(self, data, labels, **kw) -> Transformer:
        return self.fn(data, labels, **kw)


def estimator(fn: Callable[..., Transformer]) -> Estimator:
    """Lift a ``fit``-shaped function into an :class:`Estimator`."""
    return FnEstimator(fn=fn)


def label_estimator(fn: Callable[..., Transformer]) -> LabelEstimator:
    """Lift a ``fit(data, labels)``-shaped function into a
    :class:`LabelEstimator`."""
    return FnLabelEstimator(fn=fn)


@dataclasses.dataclass(eq=False)
class _SuffixedEstimator(Estimator):
    """``estimator then transformer``: the fitted model, then the suffix."""

    est: Estimator
    suffix: Transformer

    def fit(self, data, **kw) -> "Pipeline":
        return Pipeline.of(self.est.fit(data, **kw), self.suffix)


@dataclasses.dataclass(eq=False)
class _SuffixedLabelEstimator(LabelEstimator):
    est: LabelEstimator
    suffix: Transformer

    def fit(self, data, labels, **kw) -> "Pipeline":
        return Pipeline.of(self.est.fit(data, labels, **kw), self.suffix)


@dataclasses.dataclass(eq=False)
class ChainedEstimator(Estimator):
    """``prefix then estimator``: ``fit`` featurizes with the prefix first."""

    prefix: Transformer
    est: Estimator

    def fit(self, data, **kw) -> "Pipeline":
        data = _fit_entry(data)
        feats = self.prefix(data)
        _guard_feats(node_label(self.prefix), feats)
        return Pipeline.of(self.prefix, self.est.fit(feats, **kw))

    def fit_fused(self, data, **kw) -> "Pipeline":
        """The reference traces featurize and fit as one XLA program; the
        port runs eagerly, so this is :meth:`fit` under ``torch.no_grad()``,
        with the same result."""
        with torch.no_grad():
            return self.fit(data, **kw)


@dataclasses.dataclass(eq=False)
class ChainedLabelEstimator(LabelEstimator):
    """``prefix then labelEstimator``."""

    prefix: Transformer
    est: LabelEstimator

    def fit(self, data, labels, **kw) -> "Pipeline":
        """A ``GlobalRows`` ``data`` featurizes this process's row block
        only and fits the global batch through the estimator's own
        ``GlobalRows`` branch (``fits_global_rows``)."""
        from keystone_tpu_torch.parallel.multihost import GlobalRows

        rows = data if isinstance(data, GlobalRows) else None
        if rows is not None:
            if not self.est.fits_global_rows:
                raise TypeError(
                    f"{type(self.est).__name__} has no GlobalRows fit: over rows spread "
                    "across processes it would fit this process's block as the whole batch"
                )
            data = rows.local
        data = _fit_entry(data)
        feats = self.prefix(data)
        _guard_feats(node_label(self.prefix), feats)
        if rows is not None:
            feats = dataclasses.replace(rows, local=feats)
        return Pipeline.of(self.prefix, self.est.fit(feats, labels, **kw))

    def fit_fused(self, data, labels, **kw) -> "Pipeline":
        """:meth:`fit` under ``torch.no_grad()`` (see
        :meth:`ChainedEstimator.fit_fused`)."""
        with torch.no_grad():
            return self.fit(data, labels, **kw)


class FunctionNode(_Chainable):
    """Whole-dataset operation that isn't item-wise (never chunked)."""

    def __call__(self, data):
        raise NotImplementedError


def _as_transformer(node) -> Transformer:
    if isinstance(node, Transformer):
        return node
    if isinstance(node, FunctionNode):
        return transformer(node, name=type(node).__name__)
    if callable(node):
        return transformer(node)
    raise TypeError(f"not a transformer: {node!r}")


@dataclasses.dataclass(eq=False)
class Identity(Transformer):
    """No-op transformer."""

    def __call__(self, batch):
        return batch


@dataclasses.dataclass(eq=False)
class Cacher(Transformer):
    """Materialization point (the reference's ``.cache()``): waits for the
    batch's queued device work and returns it unchanged."""

    name: str = ""

    def __call__(self, batch):
        leaves = batch if isinstance(batch, (list, tuple)) else (batch,)
        for device in {t.device for t in leaves if isinstance(t, torch.Tensor)}:
            synchronize(device)
        return batch
