"""Observability — port of ``keystone_tpu/observe``.

- :mod:`.metrics` — process-wide labeled counters/gauges/timers
- :mod:`.events` — JSONL run-event log, env-gated via
  ``KEYSTONE_OBSERVE_DIR``
- :mod:`.telemetry` — live per-step stream (``steps.jsonl``)
- :mod:`.spans` — end-to-end trace spans (``spans.jsonl``)
- :mod:`.health` — rolling-baseline anomaly monitor → ``alert`` events
- :mod:`.schema` — the single registry of structured event kinds
- :mod:`.timeseries`, :mod:`.slo`, :mod:`.collector` — the segmented
  point store, the SLO burn-rate engine and the collector that tails
  run dirs into them (the fleet's availability objective, the chaos
  invariants' alerts)
- :mod:`.cost`, :mod:`.devices`, :mod:`.tracing`, :mod:`.instrument` —
  per-node cost profiles (``torch.utils.flop_counter`` plus the hand
  kernels' own counts, the card's allocator bytes), the device-memory
  monitor, ``torch.profiler`` step windows and explicit per-node
  instrumentation
- :mod:`.report`, :mod:`.top`, :mod:`.dashboard` — the run report,
  the live terminal panel and the fleet dashboard

``events`` and ``metrics`` are imported eagerly, as in the JAX package;
the others load on first import.
"""

from __future__ import annotations

from keystone_tpu_torch.observe import events, metrics  # noqa: F401
from keystone_tpu_torch.observe.events import EventLog, node_label  # noqa: F401
from keystone_tpu_torch.observe.metrics import MetricsRegistry, get_registry  # noqa: F401
