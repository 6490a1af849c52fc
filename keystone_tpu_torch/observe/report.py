"""Run-report renderer: ``python -m keystone_tpu_torch observe <run-dir>``.

The port's copy of ``keystone_tpu/observe/report.py``, its imports pointed
at ``keystone_tpu_torch``. Joins a run's wall-time events (:mod:`.events`)
with its per-node cost profiles (:mod:`.cost`) into the KeystoneML-style
operator summary: per node — calls, total/mean wall time, share of run,
counted GFLOPs and MB accessed (``-`` where not measured: the CPU has no
allocator statistics), achieved FLOP/s, and the fraction of the card's
bf16 dense peak (:data:`keystone_tpu_torch.plan.costs.DEVICE_PEAKS`, the
datasheet's; CPU runs have no peak entry and show ``-``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any

from keystone_tpu_torch.observe import cost as _cost
from keystone_tpu_torch.observe import events as _events

# The roofline basis lives in ONE place:
# :data:`keystone_tpu_torch.plan.costs.DEVICE_PEAKS` (bf16 dense peak,
# memory B/s, PCIe B/s, NVLink B/s per device kind), so the report's
# vs_peak column can never drift from the planner's estimates.
from keystone_tpu_torch.plan.costs import (  # noqa: F401 — re-exports
    DEVICE_PEAKS,
    peak_flops_for,
)

def summarize(events: list[dict]) -> dict[str, Any]:
    """Aggregate a run's events: per-node execute stats, compile brackets,
    coarse phases/spans, and run metadata."""
    nodes: dict[str, dict] = {}
    compiles: dict[str, float] = {}
    phases: list[dict] = []
    spans: list[dict] = []
    optimizes: list[dict] = []
    clusters: list[dict] = []
    serves: list[dict] = []
    fleets: list[dict] = []
    swaps: list[dict] = []
    refits: list[dict] = []
    tunes: list[dict] = []
    collectors: list[dict] = []
    alerts: list[dict] = []
    device_memory: dict | None = None
    trace_windows: list[dict] = []
    meta: dict[str, Any] = {"run": None, "wall_s": None, "status": None}
    for ev in events:
        kind = ev.get("event")
        if meta["run"] is None and ev.get("run"):
            meta["run"] = ev["run"]
        if kind == "node":
            label = str(ev.get("node", "?"))
            if ev.get("phase") == "compile":
                compiles[label] = compiles.get(label, 0.0) + ev.get("wall_s", 0.0)
                continue
            stat = nodes.setdefault(
                label,
                {"calls": 0, "total_s": 0.0, "max_s": 0.0, "failed": 0,
                 "phase": ev.get("phase", "apply")},
            )
            stat["calls"] += 1
            stat["total_s"] += ev.get("wall_s", 0.0)
            stat["max_s"] = max(stat["max_s"], ev.get("wall_s", 0.0))
            if ev.get("status") != "ok":
                stat["failed"] += 1
        elif kind == "phase":
            phases.append(ev)
        elif kind == "span":
            spans.append(ev)
        elif kind == "optimize":
            optimizes.append(ev)
        elif kind == "cluster":
            clusters.append(ev)
        elif kind == "serve":
            serves.append(ev)
        elif kind == "resilience" and str(ev.get("action", "")).startswith(
            "fleet_"
        ):
            # fleet routing/failover/restart decisions get their own
            # section (they ride the resilience schema on the wire)
            fleets.append(ev)
        elif kind == "model_swap":
            swaps.append(ev)
        elif kind == "refit":
            refits.append(ev)
        elif kind == "tune":
            tunes.append(ev)
        elif kind == "collector":
            collectors.append(ev)
        elif kind == "alert":
            alerts.append(ev)
        elif kind == "device_memory":
            device_memory = ev  # latest sample carries current watermarks
        elif kind == "trace_window":
            trace_windows.append(ev)
        elif kind == "run_end":
            meta["wall_s"] = ev.get("wall_s")
            meta["status"] = ev.get("status")
    return {
        "meta": meta,
        "nodes": nodes,
        "compiles": compiles,
        "phases": phases,
        "spans": spans,
        "optimizes": optimizes,
        "clusters": clusters,
        "serves": serves,
        "fleet": fleets,
        "model_swaps": swaps,
        "refits": refits,
        "tunes": tunes,
        "collectors": collectors,
        "alerts": alerts,
        "device_memory": device_memory,
        "trace_windows": trace_windows,
    }


def _fmt(value: float | None, scale: float = 1.0, digits: int = 2) -> str:
    if value is None:
        return "-"
    return f"{value / scale:.{digits}f}"


def render(run_dir: str) -> str:
    """The full text report for one run directory.

    The GFLOP/s and vs_peak columns assume the counted calls processed
    batches of the shape the cost profile was lowered for (the probe
    batch in the standard ``record_pipeline_profile`` flow); calls on
    other batch sizes shift those two columns by the size ratio — the
    wall-time columns are always measured truth.
    """
    # resolve ONCE so events and cost profiles come from the same run
    # even if a concurrent process appends a newer run mid-render
    run_dir = _events.resolve_run_dir(run_dir)
    events = _events.read_events(run_dir)
    summary = summarize(events)
    costs = _cost.load_profiles(run_dir)
    profiles = costs.get("profiles", {})
    peak = peak_flops_for(costs.get("device_kind"))

    lines: list[str] = []
    meta = summary["meta"]
    dev = costs.get("device_kind") or "unknown"
    ndev = costs.get("num_devices")
    lines.append(
        f"run {meta['run'] or '?'}  [{run_dir}]  "
        f"device={dev}{f' x{ndev}' if ndev else ''}  "
        f"events={len(events)}"
        + (f"  wall={meta['wall_s']:.2f}s" if meta["wall_s"] else "")
        + (f"  status={meta['status']}" if meta["status"] else "")
    )
    lines.append("")

    nodes = summary["nodes"]
    labels = sorted(set(nodes) | set(profiles))
    if labels:
        total_wall = sum(s["total_s"] for s in nodes.values()) or None
        header = (
            f"{'node':36} {'phase':7} {'calls':>5} {'total_s':>8} "
            f"{'mean_ms':>8} {'share%':>6} {'GFLOP':>9} {'MB_acc':>9} "
            f"{'GFLOP/s':>8} {'vs_peak':>7}"
        )
        lines.append(header)
        lines.append("-" * len(header))
        for label in labels:
            stat = nodes.get(label)
            prof = profiles.get(label, {})
            flops = prof.get("flops")
            bytes_acc = prof.get("bytes_accessed")
            calls = stat["calls"] if stat else 0
            total = stat["total_s"] if stat else None
            mean = total / calls if stat and calls else None
            share = (
                100.0 * total / total_wall if total is not None and total_wall else None
            )
            rate = (
                flops * calls / total
                if flops is not None and total
                else None
            )
            vs_peak = rate / peak if rate is not None and peak else None
            failed = f" ({stat['failed']} FAILED)" if stat and stat["failed"] else ""
            lines.append(
                f"{label:36} {(stat or {}).get('phase', '-'):7} {calls:>5} "
                f"{_fmt(total, digits=3):>8} {_fmt(mean, 1e-3, 1):>8} "
                f"{_fmt(share, digits=1):>6} {_fmt(flops, 1e9):>9} "
                f"{_fmt(bytes_acc, 1e6):>9} {_fmt(rate, 1e9, 1):>8} "
                f"{_fmt(vs_peak, digits=4):>7}{failed}"
            )
        lines.append("")

    if summary["compiles"]:
        lines.append("compile (first traced call):")
        for label, secs in sorted(summary["compiles"].items()):
            lines.append(f"  {label:36} {secs:8.3f}s")
        lines.append("")
    if summary["phases"]:
        lines.append("phases:")
        for ev in summary["phases"]:
            lines.append(
                f"  {str(ev.get('phase', '?')):16} "
                f"{ev.get('wall_s', 0.0):8.3f}s"
            )
        lines.append("")
    if summary["spans"]:
        lines.append("spans (log_time):")
        for ev in summary["spans"]:
            status = "" if ev.get("status") == "ok" else "  FAILED"
            lines.append(
                f"  {str(ev.get('label', '?')):36} "
                f"{ev.get('wall_s', 0.0):8.3f}s{status}"
            )
        lines.append("")
    if summary.get("optimizes"):
        lines.append("optimizer decisions (planner / staging):")
        for ev in summary["optimizes"]:
            src = ev.get("source", "?")
            decisions = ev.get("decisions")
            if decisions:
                for d in decisions:
                    fields = ", ".join(
                        f"{k}={v}" for k, v in d.items() if k != "action"
                    )
                    lines.append(
                        f"  [{src}] {d.get('action', '?')}: {fields}"
                    )
            else:
                fields = ", ".join(
                    f"{k}={v}"
                    for k, v in ev.items()
                    if k not in ("event", "source", "ts", "run", "seq")
                )
                lines.append(f"  [{src}] {fields}")
        lines.append("")
    if summary.get("clusters"):
        lines.append("cluster membership (heartbeats / supervisor):")
        for ev in summary["clusters"]:
            fields = ", ".join(
                f"{k}={v}"
                for k, v in ev.items()
                if k not in ("event", "ts", "run", "phase", "action")
            )
            lines.append(f"  {ev.get('action', '?')}: {fields}")
        lines.append("")
    if summary.get("serves"):
        lines.append("serving (request path lifecycle):")
        for ev in summary["serves"]:
            fields = ", ".join(
                f"{k}={v}"
                for k, v in ev.items()
                if k not in ("event", "ts", "run", "phase", "action")
            )
            lines.append(f"  {ev.get('action', '?')}: {fields}")
        lines.append("")
    if summary.get("fleet"):
        by_action: dict[str, int] = {}
        for ev in summary["fleet"]:
            action = str(ev.get("action", "?"))
            by_action[action] = by_action.get(action, 0) + 1
        lines.append(
            "serving fleet (router / replica lifecycle): "
            + "  ".join(
                f"{k.removeprefix('fleet_')}={v}"
                for k, v in sorted(by_action.items())
            )
        )
        for ev in summary["fleet"][-8:]:
            fields = ", ".join(
                f"{k}={v}"
                for k, v in ev.items()
                if k not in ("event", "ts", "run", "phase", "action")
                and v is not None
            )
            lines.append(f"  {ev.get('action', '?')}: {fields}")
        lines.append("")
    for key, title in (
        ("model_swaps", "model swaps (online-learning lifecycle):"),
        ("refits", "refit daemon (online-learning folds):"),
    ):
        if summary.get(key):
            lines.append(title)
            for ev in summary[key]:
                fields = ", ".join(
                    f"{k}={v}"
                    for k, v in ev.items()
                    if k not in ("event", "ts", "run", "phase", "action")
                    and v is not None
                )
                lines.append(f"  {ev.get('action', '?')}: {fields}")
            lines.append("")
    lines.extend(_tune_section(summary))
    lines.extend(_collector_section(summary))
    lines.extend(_alert_section(run_dir, summary))
    lines.extend(_goodput_section(run_dir))
    lines.extend(_telemetry_sections(run_dir, summary))
    if peak is None and profiles:
        lines.append(
            "(no bf16 peak known for this device kind — vs_peak omitted; "
            "roofline basis: plan/costs.DEVICE_PEAKS)"
        )
    if profiles and all(p.get("bytes_accessed") is None for p in profiles.values()):
        lines.append(
            "(MB_acc not measured: bytes come from the card's allocator, "
            "and these profiles were recorded off the card)"
        )
    return "\n".join(lines)


def _tune_section(summary: dict) -> list[str]:
    """The self-tuning controller's record: decision counts by action,
    the converged knob values, and the last few adjustments."""
    tunes = summary.get("tunes") or []
    if not tunes:
        return []
    by_action: dict[str, int] = {}
    knobs: dict | None = None
    for ev in tunes:
        action = str(ev.get("action", "?"))
        by_action[action] = by_action.get(action, 0) + 1
        if isinstance(ev.get("knobs"), dict):
            knobs = ev["knobs"]
    lines = [
        "autotuner (self-tuning decisions): "
        + "  ".join(f"{k}={v}" for k, v in sorted(by_action.items()))
    ]
    if knobs:
        lines.append(
            "  knobs: "
            + "  ".join(f"{k}={v}" for k, v in sorted(knobs.items()))
        )
    moves = [ev for ev in tunes if ev.get("action") != "hold"]
    for ev in moves[-6:]:
        fields = ", ".join(
            f"{k}={v}"
            for k, v in ev.items()
            if k not in ("event", "ts", "run", "action", "knobs")
            and v is not None
        )
        lines.append(f"  {ev.get('action', '?')}: {fields}")
    lines.append("")
    return lines


def _collector_section(summary: dict) -> list[str]:
    """The fleet-collector lifecycle: cycle count, last cycle's scrape
    outcome, and how many SLO pairs were firing at the end."""
    cycles = summary.get("collectors") or []
    if not cycles:
        return []
    last = cycles[-1]
    lines = ["collector:"]
    lines.append(
        f"  {len(cycles)} cycle(s); last: "
        f"{last.get('targets_ok', 0)} target(s) ok, "
        f"{last.get('targets_failed', 0)} failed, "
        f"{last.get('points', 0)} scraped point(s), "
        f"{last.get('tailed_points', 0)} tailed, "
        f"{last.get('run_dirs', 0)} run dir(s)"
    )
    firing = last.get("slo_firing")
    if firing:
        lines.append(f"  SLO: {firing} (objective, window) pair(s) FIRING")
    lines.append("")
    return lines


def _alert_section(run_dir: str, summary: dict) -> list[str]:
    """Recorded ``alert`` events (the live anomaly monitor's verdicts);
    when the run recorded none, the step stream is replayed offline
    through the same checks so a sink-only run still gets a verdict."""
    lines: list[str] = []
    alerts = summary.get("alerts") or []
    offline = False
    if not alerts:
        try:
            from keystone_tpu_torch.observe import health as _health

            alerts = [
                {"action": a.get("kind"), **a} for a in _health.check_run(run_dir)
            ]
            offline = True
        except Exception:  # noqa: BLE001 — the report must render
            alerts = []
    if not alerts:
        return lines
    by_kind: dict[str, int] = {}
    for a in alerts:
        kind = str(a.get("action", "?"))
        by_kind[kind] = by_kind.get(kind, 0) + 1
    lines.append(
        "alerts"
        + (" (offline scan of steps.jsonl)" if offline else "")
        + ": "
        + "  ".join(f"{k}={v}" for k, v in sorted(by_kind.items()))
    )
    for a in alerts[-5:]:
        fields = ", ".join(
            f"{k}={v}"
            for k, v in a.items()
            if k not in ("event", "ts", "run", "phase", "action", "kind")
            and v is not None
        )
        lines.append(f"  {a.get('action', '?')}: {fields}")
    lines.append("")
    return lines


def _goodput_section(run_dir: str) -> list[str]:
    """The span stream's "where the time went" breakdown, when the run
    recorded spans."""
    from keystone_tpu_torch.observe import spans as _spans

    try:
        span_recs = _spans.read_spans(run_dir)
    except OSError:
        return []
    if not span_recs:
        return []
    lines = _spans.render_goodput(_spans.goodput_summary(span_recs))
    lines.append(
        "  (span trees: python -m keystone_tpu_torch observe trace <run-dir>)"
    )
    lines.append("")
    return lines


def _telemetry_sections(run_dir: str, summary: dict) -> list[str]:
    """Live-telemetry report sections: the per-step stream summary
    (``steps.jsonl``), device-memory watermarks, profiler trace windows,
    and the multihost cluster roll-up (``metrics_cluster.json``)."""
    from keystone_tpu_torch.observe import telemetry as _telemetry
    from keystone_tpu_torch.observe.metrics import percentiles

    lines: list[str] = []
    steps_path = os.path.join(run_dir, _telemetry.STEPS_FILE)
    if os.path.isfile(steps_path) or os.path.isfile(steps_path + ".1"):
        # rotation-aware: a size-capped run's earliest records live in
        # the .1 generation
        recs = _events.read_jsonl_rotated(steps_path)
        # plan chunk-stream rows (source="plan") and fused-fit solver
        # rows (source="solver") carry whole-stream walls on a
        # process-lifetime sequence — summarized separately so they
        # can't inflate the per-step percentiles
        steps = [
            r
            for r in recs
            if "step" in r and r.get("source", "train") == "train"
        ]
        plan_rows = [r for r in recs if r.get("source") == "plan"]
        solver_rows = [r for r in recs if r.get("source") == "solver"]
        if steps:
            last = steps[-1]
            walls = [
                r["wall_s"]
                for r in steps
                if isinstance(r.get("wall_s"), (int, float))
            ]
            p = percentiles(walls, (50, 95, 99)) if walls else {}
            line = f"live telemetry: {len(steps)} step record(s)"
            if "step" in last:
                line += f", last step {last['step']}"
            if isinstance(last.get("loss"), (int, float)):
                line += f", loss {last['loss']:.4f}"
            lines.append(line)
            if p:
                lines.append(
                    f"  step wall p50 {p[50] * 1e3:.1f} ms  "
                    f"p95 {p[95] * 1e3:.1f} ms  p99 {p[99] * 1e3:.1f} ms"
                )
            rates = [
                r["tokens_per_s"]
                for r in steps
                if isinstance(r.get("tokens_per_s"), (int, float))
            ]
            mfus = [
                r["mfu"]
                for r in steps
                if isinstance(r.get("mfu"), (int, float))
            ]
            if rates:
                lines.append(
                    f"  tokens/s last {rates[-1]:,.0f}  "
                    f"best {max(rates):,.0f}"
                    + (f"  mfu last {mfus[-1]:.4f}" if mfus else "")
                )
            lines.append("")
        if plan_rows:
            rows = sum(
                r["rows"]
                for r in plan_rows
                if isinstance(r.get("rows"), (int, float))
            )
            rps = [
                r["rows_per_s"]
                for r in plan_rows
                if isinstance(r.get("rows_per_s"), (int, float))
            ]
            lines.append(
                f"plan chunk streams: {len(plan_rows)} record(s), "
                f"{int(rows)} row(s)"
                + (f", last {rps[-1]:,.0f} rows/s" if rps else "")
            )
            lines.append("")
        if solver_rows:
            # fused streaming fits get their own heading: one row per
            # fit (rows/s, chunks, cost-priced MFU, chosen Gram
            # operator), not mixed into the generic plan chunk lines
            lines.append(
                f"solver streams (fused streaming fits): "
                f"{len(solver_rows)} fit(s)"
            )
            for r in solver_rows[-8:]:
                parts = [f"  {r.get('estimator', '?')}"]
                if isinstance(r.get("rows"), (int, float)):
                    parts.append(f"{int(r['rows'])} rows")
                if isinstance(r.get("chunks"), (int, float)):
                    parts.append(f"{int(r['chunks'])} chunk(s)")
                if isinstance(r.get("rows_per_s"), (int, float)):
                    parts.append(f"{r['rows_per_s']:,.0f} rows/s")
                if isinstance(r.get("mfu"), (int, float)):
                    parts.append(f"mfu {r['mfu']:.4f}")
                if r.get("gram"):
                    parts.append(f"gram={r['gram']}")
                lines.append("  ".join(parts))
            lines.append("")
        serve_rows = [r for r in recs if r.get("source") == "serve"]
        if serve_rows:
            batches = [r for r in serve_rows if "bucket" in r]
            decodes = [r for r in serve_rows if r.get("kind") == "decode"]
            parts = []
            if batches:
                rows = sum(
                    r["rows"]
                    for r in batches
                    if isinstance(r.get("rows"), (int, float))
                )
                fills = [
                    r["batch_fill"]
                    for r in batches
                    if isinstance(r.get("batch_fill"), (int, float))
                ]
                part = f"{len(batches)} batch(es), {int(rows)} row(s)"
                if fills:
                    part += f", mean fill {sum(fills) / len(fills):.2f}"
                parts.append(part)
            if decodes:
                toks = sum(
                    r["tokens"]
                    for r in decodes
                    if isinstance(r.get("tokens"), (int, float))
                )
                parts.append(
                    f"{len(decodes)} generation(s), {int(toks)} token(s)"
                )
            lines.append("serving stream: " + "; ".join(parts))
            # two different walls, NOT poolable: batch rows carry the
            # per-dispatch wall, decode rows the submit-to-finish wall
            # of a whole generation (orders of magnitude apart)
            batch_walls = [
                r["wall_s"]
                for r in batches
                if isinstance(r.get("wall_s"), (int, float))
            ]
            if batch_walls:
                p = percentiles(batch_walls, (50, 95))
                lines.append(
                    f"  dispatch wall p50 {p[50] * 1e3:.1f} ms  "
                    f"p95 {p[95] * 1e3:.1f} ms"
                )
            gen_walls = [
                r["wall_s"]
                for r in decodes
                if isinstance(r.get("wall_s"), (int, float))
            ]
            if gen_walls:
                p = percentiles(gen_walls, (50, 95))
                lines.append(
                    f"  generation wall p50 {p[50] * 1e3:.1f} ms  "
                    f"p95 {p[95] * 1e3:.1f} ms"
                )
            lines.append("")
    devmem = summary.get("device_memory")
    if devmem:
        lines.append("device memory (HBM watermarks, latest sample):")
        for d in devmem.get("devices") or []:
            limit = d.get("bytes_limit") or 0
            pct = (
                f"  ({100.0 * d['peak_bytes_in_use'] / limit:.0f}% of limit)"
                if limit
                else ""
            )
            lines.append(
                f"  {d.get('device', '?'):12} "
                f"in-use {d.get('bytes_in_use', 0) / 2**30:7.2f} GiB  "
                f"peak {d.get('peak_bytes_in_use', 0) / 2**30:7.2f} GiB{pct}"
            )
        lines.append("")
    if summary.get("trace_windows"):
        started = [
            ev
            for ev in summary["trace_windows"]
            if ev.get("status") == "started"
        ]
        if started:
            lines.append("profiler trace windows:")
            for ev in started:
                lines.append(
                    f"  step {ev.get('step', '?')} x{ev.get('steps', '?')} "
                    f"({ev.get('reason', '?')}) -> {ev.get('dir', '?')}"
                )
            lines.append("")
    cluster_path = os.path.join(run_dir, "metrics_cluster.json")
    if os.path.isfile(cluster_path):
        try:
            with open(cluster_path) as f:
                cluster = json.load(f)
        except (OSError, ValueError):
            cluster = None
        if cluster and cluster.get("metrics"):
            series = cluster["metrics"]
            lines.append(
                f"cluster metrics roll-up ({cluster.get('hosts', '?')} "
                f"host(s), {len(series)} series):"
            )
            for key in sorted(series)[:40]:
                val = series[key]
                if isinstance(val, dict):
                    parts = f"count={val.get('count', 0)}"
                    if "total_s" in val:
                        parts += f" total={val['total_s']:.3f}s"
                    if "p95_s" in val:
                        parts += f" p95={val['p95_s'] * 1e3:.1f}ms"
                    lines.append(f"  {key:44} {parts}")
                else:
                    lines.append(f"  {key:44} {val}")
            if len(series) > 40:
                lines.append(f"  ... {len(series) - 40} more")
            lines.append("")
    return lines


def per_node_breakdown(
    log: "_events.EventLog",
    profiles: dict[str, dict] | None = None,
    since: int = 0,
) -> dict[str, dict]:
    """Compact per-node dict for embedding in machine artifacts (bench):
    node label → calls/wall plus flops/bytes when profiled. ``since``
    restricts to records appended after that index — pass the record
    count captured before your instrumented apply when reusing an
    ambient log, so unrelated earlier events don't leak in."""
    summary = summarize(log.records[since:])
    out: dict[str, dict] = {}
    for label, stat in summary["nodes"].items():
        entry = {
            "calls": stat["calls"],
            "wall_s": round(stat["total_s"], 6),
        }
        prof = (profiles or {}).get(label, {})
        if "flops" in prof:
            entry["flops"] = prof["flops"]
        if "bytes_accessed" in prof:
            entry["bytes_accessed"] = prof["bytes_accessed"]
        out[label] = entry
    if not out and getattr(log, "dropped", 0):
        # the in-memory mirror hit its cap before these events: say so
        # rather than returning {} that reads as "no nodes ran" (the
        # file sink, when present, still has the full record)
        return {
            "error": f"{log.dropped} event records dropped (in-memory cap)"
        }
    return out


# ------------------------------------------------------------- run diff


def _diff_profile(run_dir: str) -> dict[str, Any]:
    """One run's comparable summary: goodput bucket shares (spans),
    train step-wall percentiles + rates (steps.jsonl), and per-kind /
    per-action event counts — the three axes ``observe diff`` renders."""
    from keystone_tpu_torch.observe import spans as _spans
    from keystone_tpu_torch.observe import telemetry as _telemetry
    from keystone_tpu_torch.observe import top as _top
    from keystone_tpu_torch.observe.metrics import percentiles

    run_dir = _top.resolve_run_dir(run_dir)
    out: dict[str, Any] = {
        "dir": run_dir,
        "goodput": None,
        "steps": {},
        "counts": {},
    }
    try:
        span_recs = _spans.read_spans(run_dir)
    except OSError:
        span_recs = []
    if span_recs:
        out["goodput"] = _spans.goodput_summary(span_recs)
    steps_path = os.path.join(run_dir, _telemetry.STEPS_FILE)
    if os.path.isfile(steps_path) or os.path.isfile(steps_path + ".1"):
        recs = _events.read_jsonl_rotated(steps_path)
        train = [
            r
            for r in recs
            if "step" in r and r.get("source", "train") == "train"
        ]
        walls = [
            r["wall_s"]
            for r in train
            if isinstance(r.get("wall_s"), (int, float))
        ]
        st: dict[str, Any] = {"n": len(train)}
        if walls:
            st["wall_p"] = percentiles(walls, (50, 95, 99))
        rates = [
            r["tokens_per_s"]
            for r in train
            if isinstance(r.get("tokens_per_s"), (int, float))
        ]
        if rates:
            st["tokens_per_s_best"] = max(rates)
        stream_rates = [
            r["rows_per_s"]
            for r in recs
            if r.get("source") in ("plan", "solver")
            and isinstance(r.get("rows_per_s"), (int, float))
        ]
        if stream_rates:
            st["rows_per_s_best"] = max(stream_rates)
        out["steps"] = st
    try:
        events = _events.read_events(run_dir)
    except OSError:
        events = []
    counts: dict[str, int] = {}
    for ev in events:
        kind = str(ev.get("event", "?"))
        counts[kind] = counts.get(kind, 0) + 1
        if ev.get("action") and kind in (
            "resilience",
            "cluster",
            "alert",
            "tune",
            "model_swap",
            "refit",
            "serve",
        ):
            key = f"{kind}.{ev['action']}"
            counts[key] = counts.get(key, 0) + 1
    out["counts"] = counts
    return out


def render_diff(dir_a: str, dir_b: str) -> str:
    """``observe diff <dirA> <dirB>``: side-by-side goodput shares,
    step-time percentiles, and event-counter deltas between two run
    dirs — the tuned-vs-static comparison, by hand."""
    a = _diff_profile(dir_a)
    b = _diff_profile(dir_b)
    lines = [
        f"A: {a['dir']}",
        f"B: {b['dir']}",
        "",
    ]
    ga, gb = a["goodput"], b["goodput"]
    if ga or gb:
        lines.append(
            f"goodput shares (A: {len((ga or {}).get('buckets', {}))} "
            f"bucket(s) over {(ga or {}).get('total_s', 0.0):.3f}s, "
            f"B: over {(gb or {}).get('total_s', 0.0):.3f}s):"
        )
        buckets = sorted(
            set((ga or {}).get("buckets", {}))
            | set((gb or {}).get("buckets", {}))
        )
        lines.append(f"  {'bucket':12} {'A':>8} {'B':>8} {'Δ':>9}")
        for bucket in buckets:
            sa = ((ga or {}).get("buckets", {}).get(bucket) or {}).get(
                "share", 0.0
            )
            sb = ((gb or {}).get("buckets", {}).get(bucket) or {}).get(
                "share", 0.0
            )
            lines.append(
                f"  {bucket:12} {sa * 100:7.1f}% {sb * 100:7.1f}% "
                f"{(sb - sa) * 100:+8.1f}pp"
            )
        lines.append("")
    sa, sb = a["steps"], b["steps"]
    if sa or sb:
        lines.append(
            f"steps: A {sa.get('n', 0)} record(s), B {sb.get('n', 0)}"
        )
        pa, pb = sa.get("wall_p") or {}, sb.get("wall_p") or {}
        for q in (50, 95, 99):
            if q in pa or q in pb:
                va, vb = pa.get(q), pb.get(q)
                delta = (
                    f"{(vb - va) / va * 100:+6.1f}%"
                    if va and vb is not None
                    else "      -"
                )
                lines.append(
                    f"  wall p{q:<3} "
                    f"{_fmt(va, 1e-3, 1):>8} ms {_fmt(vb, 1e-3, 1):>8} ms "
                    f"{delta}"
                )
        for key, label in (
            ("tokens_per_s_best", "tokens/s best"),
            ("rows_per_s_best", "rows/s best"),
        ):
            va, vb = sa.get(key), sb.get(key)
            if va is not None or vb is not None:
                delta = (
                    f"{(vb - va) / va * 100:+6.1f}%"
                    if va and vb is not None
                    else "      -"
                )
                lines.append(
                    f"  {label:12} {_fmt(va, digits=1):>10} "
                    f"{_fmt(vb, digits=1):>10} {delta}"
                )
        lines.append("")
    keys = sorted(set(a["counts"]) | set(b["counts"]))
    if keys:
        lines.append("event counts (A -> B):")
        for key in keys:
            ca, cb = a["counts"].get(key, 0), b["counts"].get(key, 0)
            if ca == cb:
                continue
            lines.append(f"  {key:28} {ca:>6} -> {cb:<6} ({cb - ca:+d})")
        if all(
            a["counts"].get(k, 0) == b["counts"].get(k, 0) for k in keys
        ):
            lines.append("  (identical)")
    return "\n".join(lines).rstrip()


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "diff":
        # tuned-vs-static comparison: `observe diff <dirA> <dirB>`
        if len(argv) != 3:
            raise SystemExit(
                "usage: python -m keystone_tpu_torch observe diff <dirA> <dirB>"
            )
        try:
            print(render_diff(argv[1], argv[2]))
        except OSError as e:
            raise SystemExit(str(e)) from None
        return
    if argv and argv[0] == "top":
        # the live dashboard: `observe top <dir> [--once] [--interval S]`
        from keystone_tpu_torch.observe import top as _top

        return _top.main(argv[1:])
    if argv and argv[0] == "trace":
        # span trees: `observe trace <dir> [--request ID] [--limit N]`
        from keystone_tpu_torch.observe import spans as _spans

        return _spans.main(argv[1:])
    if argv and argv[0] == "collect":
        # the fleet collector daemon: scrape + tail → time-series store
        from keystone_tpu_torch.observe import collector as _collector

        return _collector.main(argv[1:])
    if argv and argv[0] == "slo":
        # burn-rate status over a collector store: `observe slo <dir>`
        from keystone_tpu_torch.observe import slo as _slo

        return _slo.main(argv[1:])
    if argv and argv[0] == "serve":
        # the live fleet dashboard: `observe serve <dir> --port N`
        from keystone_tpu_torch.observe import dashboard as _dashboard

        return _dashboard.main(argv[1:])
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit(
            "usage: python -m keystone_tpu_torch observe <run-dir>\n"
            "       python -m keystone_tpu_torch observe top <run-dir> [--once]"
            " [--interval S]\n"
            "       python -m keystone_tpu_torch observe trace <run-dir>"
            " [--request ID] [--limit N]\n"
            "       python -m keystone_tpu_torch observe diff <dirA> <dirB>\n"
            "       python -m keystone_tpu_torch observe collect <out-dir>"
            " [--router URL] [--watch DIR] [--once]\n"
            "       python -m keystone_tpu_torch observe slo <out-dir>"
            " [--config FILE]\n"
            "       python -m keystone_tpu_torch observe serve <out-dir>"
            " [--port N]\n"
            "<run-dir> is a directory containing events.jsonl, or a base\n"
            "KEYSTONE_OBSERVE_DIR (the newest run under it is rendered;\n"
            "`top` on a base dir tails EVERY run dir, live);\n"
            "`trace` renders spans.jsonl as per-trace span trees with a\n"
            "critical-path summary and the goodput bucket breakdown;\n"
            "`diff` renders side-by-side goodput shares, step-time\n"
            "percentiles, and event-counter deltas between two runs;\n"
            "`collect` runs the fleet collector (scrapes /metrics,\n"
            "tails run dirs, evaluates SLOs into <out-dir>/tsdb);\n"
            "`slo` renders burn-rate status + alert history over a\n"
            "collector store; `serve` is the live fleet dashboard with\n"
            "/api/query range queries and federation /metrics"
        )
    try:
        print(render(argv[0]))
    except OSError as e:
        # missing dir, events.jsonl passed instead of its directory, ...
        raise SystemExit(str(e)) from None


if __name__ == "__main__":
    main()
