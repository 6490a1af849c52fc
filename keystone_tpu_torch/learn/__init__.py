"""Online learning: the streaming-fit state becomes a live model — port
of ``keystone_tpu/learn/``.

The fit protocol (``fit_stats_init/update/finalize`` in
:mod:`keystone_tpu_torch.ops.linear` and :mod:`keystone_tpu_torch.ops.
weighted_linear`) is an incremental learner: running (AᵀA, AᵀB, μ, n)
statistics fold new labeled chunks in O(chunk·D²) and re-finalize in
O(D³) without revisiting old rows. This package closes the loop
train → serve → observe → retrain:

- :mod:`.merge` — ``fit_stats_merge`` (Chan's pairwise merge for
  ``NormalEqState``, addition for ``WeightedEqState``) and digest-checked
  ``save_fit_state`` / ``load_fit_state``;
- :mod:`.refit` — the refit daemon (``python -m
  keystone_tpu_torch.learn.refit <state> --watch <dir>``): folds new
  chunks through the fused segment (:func:`keystone_tpu_torch.plan.
  executor.fit_stream`, K1 on the card under the int8 Gram), re-finalizes
  and publishes a versioned fitted pipeline;
- :mod:`.swap` — hot swap of the running server's model under traffic
  (``POST /admin/reload``, SIGHUP): load through the spec check, capture
  the candidate's graphs, probe, commit; a failure keeps the incumbent;
- :mod:`.shadow` — shadow A/B promotion: the candidate scores sampled live
  requests, and promotion is gated on divergence and feature drift.

Across processes, ``allmerge_fit_state`` merges every process's state in
rank order over the process group (:mod:`keystone_tpu_torch.parallel.multihost`).
"""

from __future__ import annotations

from keystone_tpu_torch.learn.merge import (
    FitState,
    FitStateError,
    allmerge_fit_state,
    fit_stats_merge,
    load_fit_state,
    save_fit_state,
)
from keystone_tpu_torch.learn.swap import ModelSwapper, SwapError

__all__ = [
    "FitState",
    "FitStateError",
    "ModelSwapper",
    "SwapError",
    "allmerge_fit_state",
    "fit_stats_merge",
    "load_fit_state",
    "save_fit_state",
]
