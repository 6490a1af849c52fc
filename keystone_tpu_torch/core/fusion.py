"""Pipeline operator fusion — port of ``keystone_tpu/core/fusion.py``.

:func:`optimize` walks a fitted :class:`Pipeline` and replaces adjacent
node windows with fused equivalents. Its rules register with the
planner's pass registry (:mod:`keystone_tpu_torch.plan.passes`), so the
planner applies them too. The rule here:

- ``conv_rectify_pool``: ``Convolver >> SymmetricRectifier >> Pooler`` →
  :class:`~keystone_tpu_torch.ops.images.FusedConvRectifyPool`, which
  pools each rectifier half before the channel concat so the
  (N, oh, ow, 2F) map never exists. Only a default Convolver
  (``precision`` None, ``impl`` "auto") before a Pooler with no
  ``pixel_fn`` is rewritten: those are the cases with the same numbers.

An input with nothing to rewrite comes back as the same object.
"""

from __future__ import annotations

from keystone_tpu_torch.core.pipeline import Pipeline, Transformer
from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.plan import passes as _passes


@_passes.rewrite_rule("conv_rectify_pool", window=3)
def _try_fuse_conv_chain(a, b, c):
    from keystone_tpu_torch.ops.images import (
        Convolver,
        FusedConvRectifyPool,
        Pooler,
        SymmetricRectifier,
    )

    if not (
        isinstance(a, Convolver)
        and isinstance(b, SymmetricRectifier)
        and isinstance(c, Pooler)
    ):
        return None
    # the chain applies pixel_fn to the concatenated 2F map, which the
    # fused node never holds; an explicit precision or impl asked for
    # numbers or a schedule the fused node would not honour
    if c.pixel_fn is not None:
        return None
    if a.precision is not None or a.impl != "auto":
        return None
    return FusedConvRectifyPool(
        filters=a.filters,
        whitener_means=a.whitener_means,
        patch_size=a.patch_size,
        normalize_patches=a.normalize_patches,
        var_constant=a.var_constant,
        alpha=b.alpha,
        max_val=b.max_val,
        pool_stride=c.stride,
        pool_size=c.pool_size,
        pool_fn=c.pool_fn,
    )


def optimize(pipe: Transformer) -> Transformer:
    """Rewrite the fusable node windows of a fitted pipeline. Counts
    ``fusion_rewrites`` by rule and emits one ``optimize`` event a rule
    to the active event log."""
    if not isinstance(pipe, Pipeline):
        return pipe
    out, decisions = _passes.rewrite_nodes(pipe.nodes)
    if not decisions:
        return pipe
    by_rule: dict[str, int] = {}
    for d in decisions:
        by_rule[d["rule"]] = by_rule.get(d["rule"], 0) + 1
    log = _events.active()
    for rule, rewrites in by_rule.items():
        _metrics.get_registry().counter("fusion_rewrites", rule=rule).inc(rewrites)
        if log is not None:
            log.emit(
                "optimize",
                rule=rule,
                rewrites=rewrites,
                nodes_before=len(pipe.nodes),
                nodes_after=len(out),
            )
    return Pipeline(nodes=tuple(out))
