"""Persisted plan store: learned (plan + knob) records per pipeline.

The port's copy of ``keystone_tpu/plan/store.py``, its imports pointed at
``keystone_tpu_torch``; the device kind is
:func:`keystone_tpu_torch.plan.costs.device_kind` (the card's name).

The planner re-derives chunk size / stage depth from static cost
profiles on every run, and the autotuner (:mod:`.tune`) re-learns the
live knobs from scratch. This module is the memory between runs: a
directory of small JSON records (``KEYSTONE_PLAN_STORE``), one per
(pipeline fingerprint, device kind), each holding the final knob
settings, the plan's headline choices, and provenance (run id, goodput,
when). :func:`keystone_tpu_torch.plan.plan_pipeline` seeds new plans from the
matching record, and the autotuner persists on every committed
improvement — so the second run starts where the first one converged.

Records are written with the atomic temp+\\ ``os.replace`` helper
(:func:`keystone_tpu_torch.core.serialization.atomic_write`): a reader — a
concurrent run, the ``plan <model> --learned`` CLI — sees either the
old complete record or the new one, never a torn file. Loads verify the
embedded fingerprint against the requested one and refuse a mismatch
loudly (:class:`PlanStoreError`): a renamed or hand-edited record must
never silently seed the wrong pipeline's knobs.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any

ENV_STORE = "KEYSTONE_PLAN_STORE"

_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


class PlanStoreError(ValueError):
    """A store record that must not be used: its embedded fingerprint
    disagrees with the pipeline asking for it. Loud by design — seeding
    a plan from another pipeline's learned knobs would silently detune
    both."""


def store_dir() -> str | None:
    """The ``KEYSTONE_PLAN_STORE`` directory, or None when the store is
    disabled (the default)."""
    raw = os.environ.get(ENV_STORE, "").strip()
    return raw or None


def fingerprint(labels: list[str], **extra: Any) -> str:
    """Stable pipeline identity: sha256 over the ordered node labels
    (``00:Scale`` style — class names + positions, no weights) plus any
    extra identity fields, truncated to 16 hex chars."""
    payload = json.dumps(
        {"nodes": list(labels), **extra}, sort_keys=True, default=repr
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _path(base: str, fp: str, device_kind: str | None) -> str:
    kind = _SAFE.sub("-", device_kind or "unknown").strip("-") or "unknown"
    return os.path.join(base, f"{fp}__{kind}.json")


def save(
    fp: str,
    record: dict,
    *,
    device_kind: str | None = None,
    base: str | None = None,
) -> str | None:
    """Persist a learned record for ``fp`` (atomic write). Returns the
    path, or None when no store is configured."""
    from keystone_tpu_torch.core.serialization import atomic_write
    from keystone_tpu_torch.observe import metrics as _metrics

    base = base or store_dir()
    if not base:
        return None
    os.makedirs(base, exist_ok=True)
    payload = {
        "fingerprint": fp,
        "device_kind": device_kind,
        "saved_ts": time.time(),
        **record,
    }
    path = _path(base, fp, device_kind)
    with atomic_write(path) as f:
        f.write(json.dumps(payload, indent=1, default=repr).encode())
    _metrics.get_registry().counter("plan_store_saves").inc()
    return path


def load(
    fp: str,
    *,
    device_kind: str | None = None,
    base: str | None = None,
) -> dict | None:
    """The learned record for ``fp`` on this device kind, or None when
    absent / the store is disabled / the file is unreadable (warned and
    counted — a corrupt record degrades to an untuned start). A record
    whose embedded fingerprint disagrees with ``fp`` raises
    :class:`PlanStoreError` — that is tampering, not staleness."""
    from keystone_tpu_torch.observe import metrics as _metrics

    base = base or store_dir()
    if not base:
        return None
    path = _path(base, fp, device_kind)
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        from keystone_tpu_torch.core.logging import get_logger

        get_logger("keystone_tpu_torch.plan").warning(
            "plan store record %s unreadable (%r); starting untuned",
            path,
            e,
        )
        _metrics.get_registry().counter("plan_store_corrupt").inc()
        return None
    if payload.get("fingerprint") != fp:
        _metrics.get_registry().counter("plan_store_mismatch").inc()
        raise PlanStoreError(
            f"{path}: stored fingerprint "
            f"{payload.get('fingerprint')!r} != requested {fp!r} — "
            "refusing to seed knobs from another pipeline's record"
        )
    _metrics.get_registry().counter("plan_store_hits").inc()
    return payload


def entries(base: str | None = None) -> list[dict]:
    """Every readable record in the store (the ``--learned`` CLI's
    listing), newest first."""
    base = base or store_dir()
    if not base or not os.path.isdir(base):
        return []
    out: list[dict] = []
    for name in os.listdir(base):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(base, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    out.sort(key=lambda r: float(r.get("saved_ts") or 0.0), reverse=True)
    return out


def describe(record: dict) -> list[str]:
    """Human-readable lines for one learned record (CLI + report)."""
    prov = record.get("provenance") or {}
    lines = [
        f"learned plan {record.get('fingerprint', '?')}  "
        f"device={record.get('device_kind') or 'unknown'}"
    ]
    knobs = record.get("knobs") or {}
    if knobs:
        lines.append(
            "  knobs: "
            + "  ".join(f"{k}={v}" for k, v in sorted(knobs.items()))
        )
    plan = record.get("plan") or {}
    if plan:
        lines.append(
            "  plan:  "
            + "  ".join(
                f"{k}={v}"
                for k, v in sorted(plan.items())
                if k != "nodes" and v is not None
            )
        )
        if plan.get("nodes"):
            lines.append("  nodes: " + " -> ".join(plan["nodes"]))
    when = record.get("saved_ts")
    stamp = (
        time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(float(when)))
        if when
        else "?"
    )
    lines.append(
        f"  provenance: run={prov.get('run') or '?'}  "
        f"goodput={prov.get('goodput', '?')}  evals={prov.get('evals', '?')}  "
        f"saved={stamp}"
    )
    return lines
