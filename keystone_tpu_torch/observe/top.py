"""``observe top`` — a curses-free terminal dashboard for a live run.

The port's copy of ``keystone_tpu/observe/top.py``, its imports pointed at
``keystone_tpu_torch``.

Tails a run directory's ``steps.jsonl`` (:mod:`.telemetry`) and
``events.jsonl`` (:mod:`.events`) and refreshes a one-screen summary:
step rate / tokens-per-sec / MFU, a loss sparkline, per-device HBM
watermarks, and the resilience / planner decision counters. Pure file
tailing — it attaches to any live or finished run, local or on a shared
filesystem, with no jax import and no code running in the trained
process.

Usage::

    python -m keystone_tpu_torch observe top <dir> [--once] [--interval S]

``--once`` renders one snapshot and exits (tests, CI artifacts, piping
to a file); otherwise the screen refreshes in place until Ctrl-C.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Any

from keystone_tpu_torch.observe import events as _events
from keystone_tpu_torch.observe import telemetry as _telemetry

SPARK = "▁▂▃▄▅▆▇█"
_RATE_WINDOW = 32  # steps the instantaneous rate is averaged over
_LOSS_WINDOW = 60  # sparkline width


class Tail:
    """Incremental JSONL reader: repeated :meth:`poll` calls parse only
    bytes appended since the last call, never re-reading the file.
    Complete lines only — a torn final line is left for the next poll.
    A truncated/rotated file restarts from the top."""

    def __init__(self, path: str, keep: int = 4096):
        self.path = path
        self.offset = 0
        self.records: list[dict] = []
        self.keep = keep

    def poll(self) -> list[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return self.records
        if size < self.offset:  # truncated underneath us: start over
            self.offset, self.records = 0, []
        if size == self.offset:
            return self.records
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            chunk = f.read()
        end = chunk.rfind(b"\n")
        if end < 0:
            return self.records
        self.offset += end + 1
        for raw in chunk[: end + 1].splitlines():
            raw = raw.strip()
            if not raw:
                continue
            try:
                self.records.append(json.loads(raw))
            except ValueError:
                continue
        if len(self.records) > self.keep:
            del self.records[: len(self.records) - self.keep]
        return self.records


#: fleet mode tails run dirs whose streams moved within this window —
#: a base dir accumulating months of finished runs must not pour every
#: dead run's alerts and losses into the live view
_FLEET_FRESH_S = 3600.0


class FleetTails:
    """Tails EVERY *live* run dir under a base observe directory,
    rediscovering on each poll. A router and its replicas each write
    their own run dir; a replica relaunched by a rolling restart writes
    a NEW one, and the operator staring at the dashboard must see it
    appear live, not restart ``observe top``. Run dirs whose files
    haven't moved for :data:`_FLEET_FRESH_S` are skipped at discovery
    (when nothing is fresh, the newest stale run is tailed so the
    command still shows something). Files are read through the
    collector's rotation-safe cursor — a size-capped ``steps.jsonl``
    rolling to ``.1`` mid-watch must not wipe the dashboard's history —
    with bounded in-memory accumulation, merged and ts-sorted so
    :func:`summarize` treats the fleet as one stream."""

    _KEEP = 4096  # records kept per file, the Tail bound

    def __init__(self, base: str):
        self.base = base
        self._tails: dict[str, tuple[Any, Any, list[dict], list[dict]]] = {}

    def _fresh(self, run_dir: str) -> float | None:
        """Newest stream mtime under ``run_dir`` (None = no streams)."""
        newest = None
        for f in (_telemetry.STEPS_FILE, _events.EVENTS_FILE):
            try:
                mtime = os.path.getmtime(os.path.join(run_dir, f))
            except OSError:
                continue
            newest = mtime if newest is None else max(newest, mtime)
        return newest

    def _discover(self) -> None:
        from keystone_tpu_torch.observe.collector import _Cursor

        try:
            names = os.listdir(self.base)
        except OSError:
            return
        candidates: dict[str, float] = {}
        for name in sorted(names):
            run_dir = os.path.join(self.base, name)
            if run_dir in self._tails or not os.path.isdir(run_dir):
                continue
            mtime = self._fresh(run_dir)
            if mtime is not None:
                candidates[run_dir] = mtime
        now = time.time()
        live = {
            d for d, m in candidates.items() if now - m <= _FLEET_FRESH_S
        }
        if not live and candidates and not self._tails:
            # nothing fresh anywhere: show the newest finished run
            live = {max(candidates, key=candidates.get)}
        for run_dir in sorted(live):
            self._tails[run_dir] = (
                _Cursor(os.path.join(run_dir, _telemetry.STEPS_FILE)),
                _Cursor(os.path.join(run_dir, _events.EVENTS_FILE)),
                [],
                [],
            )

    def poll(self) -> tuple[list[dict], list[dict]]:
        self._discover()
        steps: list[dict] = []
        events: list[dict] = []
        for step_cur, event_cur, step_kept, event_kept in self._tails.values():
            for cur, kept in ((step_cur, step_kept), (event_cur, event_kept)):
                kept.extend(cur.poll())
                if len(kept) > self._KEEP:
                    del kept[: len(kept) - self._KEEP]
            steps.extend(step_kept)
            events.extend(event_kept)
        key = lambda r: float(r.get("ts") or 0.0)  # noqa: E731
        steps.sort(key=key)
        events.sort(key=key)
        return steps, events

    @property
    def run_count(self) -> int:
        return len(self._tails)


def sparkline(values: list[float], width: int = _LOSS_WINDOW) -> str:
    # non-finite values (a NaN'd loss — exactly when someone is staring
    # at the dashboard) render as the full bar instead of crashing the
    # watch loop mid-incident
    numeric = [v for v in values[-width:] if isinstance(v, (int, float))]
    if not numeric:
        return ""
    vals = [v for v in numeric if math.isfinite(v)]
    # an ALL-non-finite window (divergence that stuck) still renders —
    # a vanished loss line mid-incident would be worse than any scale
    lo, hi = (min(vals), max(vals)) if vals else (0.0, 0.0)
    span = (hi - lo) or 1.0
    out = []
    for v in numeric:
        if not math.isfinite(v):
            out.append(SPARK[-1])
            continue
        out.append(SPARK[int((v - lo) / span * (len(SPARK) - 1))])
    return "".join(out)


def _fmt_bytes(n: float | None) -> str:
    if not n:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return "-"


def _fmt_rate(v: float | None, unit: str = "") -> str:
    if v is None:
        return "-"
    for scale, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {suffix}{unit}"
    return f"{v:.2f} {unit}".rstrip()


def summarize(steps: list[dict], events: list[dict]) -> dict[str, Any]:
    """Aggregate the tailed records into the render model (split from
    rendering so tests and other frontends can assert on it)."""
    out: dict[str, Any] = {
        "run": None,
        "status": "running",
        "n_events": len(events),
        "n_steps": 0,
        "last_step": None,
        "steps_per_s": None,
        "tokens_per_s": None,
        "mfu": None,
        "loss": None,
        "losses": [],
        "devices": [],
        "hbm_peak_bytes": None,
        "resilience": {},
        "cluster": {},
        "alerts": {},
        "last_alert": None,
        "plan_decisions": 0,
        "plan_streams": 0,
        "trace_windows": 0,
        "serve": {},
        "fleet": {},
        "tune": {},
        "last_ts": None,
    }
    # the stream mixes sources: train steps (source="train") carry the
    # loss/step-rate the header renders; plan chunk streams
    # (source="plan") ride a process-lifetime sequence, not a step
    # index, and must not pollute the step-rate math
    train = [
        r
        for r in steps
        if "step" in r and r.get("source", "train") == "train"
    ]
    plan_rows = [r for r in steps if r.get("source") == "plan"]
    out["plan_streams"] = len(plan_rows)
    if plan_rows:
        out["last_ts"] = plan_rows[-1].get("ts")
    # serving stream rows: micro-batch dispatches (rows/bucket/batch_fill
    # per batch) and finished generations (kind="decode", tokens per
    # request) — the serving panel's live numbers
    serve_rows = [r for r in steps if r.get("source") == "serve"]
    if serve_rows:
        sv: dict[str, Any] = out["serve"]
        batches = [r for r in serve_rows if "bucket" in r]
        decodes = [r for r in serve_rows if r.get("kind") == "decode"]
        if batches:
            sv["batches"] = len(batches)
            sv["rows"] = int(
                sum(
                    r["rows"]
                    for r in batches
                    if isinstance(r.get("rows"), (int, float))
                )
            )
            fills = [
                r["batch_fill"]
                for r in batches
                if isinstance(r.get("batch_fill"), (int, float))
            ]
            if fills:
                sv["batch_fill"] = sum(fills) / len(fills)
        if decodes:
            sv["generations"] = len(decodes)
            sv["tokens"] = int(
                sum(
                    r["tokens"]
                    for r in decodes
                    if isinstance(r.get("tokens"), (int, float))
                )
            )
        out["last_ts"] = max(
            out["last_ts"] or 0, serve_rows[-1].get("ts") or 0
        ) or None
    out["n_steps"] = len(train)
    if train:
        last = train[-1]
        out["run"] = last.get("run")
        out["last_step"] = last.get("step")
        out["loss"] = last.get("loss")
        out["tokens_per_s"] = last.get("tokens_per_s")
        out["mfu"] = last.get("mfu")
        out["losses"] = [
            r["loss"] for r in train if isinstance(r.get("loss"), (int, float))
        ]
        out["last_ts"] = max(out["last_ts"] or 0, last.get("ts") or 0) or None
        window = train[-_RATE_WINDOW:]
        if len(window) >= 2:
            dt = window[-1].get("ts", 0) - window[0].get("ts", 0)
            if dt > 0:
                out["steps_per_s"] = (len(window) - 1) / dt
        elif last.get("wall_s"):
            out["steps_per_s"] = 1.0 / last["wall_s"]
        peaks = [
            r["hbm_peak_bytes"]
            for r in train
            if isinstance(r.get("hbm_peak_bytes"), (int, float))
        ]
        if peaks:
            out["hbm_peak_bytes"] = max(peaks)
    for ev in events:
        kind = ev.get("event")
        if out["run"] is None and ev.get("run"):
            out["run"] = ev["run"]
        if ev.get("ts"):
            out["last_ts"] = max(out["last_ts"] or 0, ev["ts"])
        if kind == "run_end":
            out["status"] = ev.get("status") or "done"
        elif kind == "resilience":
            action = str(ev.get("action", "?"))
            if action.startswith("fleet_"):
                # fleet routing/failover/lifecycle decisions render in
                # their own panel (per-replica state + counters), not
                # the generic resilience counter line
                fl = out["fleet"]
                if action == "fleet_replica_state":
                    fl.setdefault("replicas", {})[
                        str(ev.get("replica"))
                    ] = {
                        "state": ev.get("state"),
                        "port": ev.get("port"),
                        "restarts": ev.get("restarts", 0),
                    }
                elif action == "fleet_stats":
                    for key in ("routed", "shed", "failover", "hedges"):
                        if ev.get(key) is not None:
                            fl[key] = ev[key]
                    for rid, state in (ev.get("replicas") or {}).items():
                        fl.setdefault("replicas", {}).setdefault(
                            str(rid), {}
                        )["state"] = state
                else:
                    fl.setdefault("events", {})
                    fl["events"][action] = fl["events"].get(action, 0) + 1
                continue
            out["resilience"][action] = out["resilience"].get(action, 0) + 1
        elif kind == "cluster":
            action = str(ev.get("action", "?"))
            out["cluster"][action] = out["cluster"].get(action, 0) + 1
        elif kind == "alert":
            action = str(ev.get("action", "?"))
            out["alerts"][action] = out["alerts"].get(action, 0) + 1
            out["last_alert"] = ev
        elif kind == "serve":
            sv = out["serve"]
            action = str(ev.get("action", "?"))
            if action == "start":
                sv["model"] = ev.get("model")
                sv["port"] = ev.get("port")
                sv["cold_start_s"] = ev.get("cold_start_s")
                sv["status"] = "serving"
            elif action == "stop":
                sv["status"] = "stopped"
        elif kind == "model_swap":
            # the online-learning lifecycle: committed swaps advance the
            # served version; rollbacks count separately (the panel must
            # show a failed candidate never took over)
            sv = out["serve"]
            action = str(ev.get("action", "?"))
            if action == "swap":
                sv["version"] = ev.get("new_version")
                sv["swaps"] = sv.get("swaps", 0) + 1
            elif action == "rollback":
                sv["rollbacks"] = sv.get("rollbacks", 0) + 1
        elif kind == "tune":
            # the autotuner panel: current knob snapshot (each event
            # carries it) + the last non-hold decision
            tn = out["tune"]
            tn["decisions"] = tn.get("decisions", 0) + 1
            action = str(ev.get("action", "?"))
            tn[action] = tn.get(action, 0) + 1
            if isinstance(ev.get("knobs"), dict):
                tn["knobs"] = ev["knobs"]
            if action != "hold":
                tn["last"] = ev
        elif kind == "optimize":
            out["plan_decisions"] += len(ev.get("decisions") or []) or 1
        elif kind == "trace_window":
            if ev.get("status") == "started":
                out["trace_windows"] += 1
        elif kind == "device_memory":
            out["devices"] = ev.get("devices") or out["devices"]
            if ev.get("peak_bytes"):
                out["hbm_peak_bytes"] = max(
                    out["hbm_peak_bytes"] or 0, ev["peak_bytes"]
                )
    return out


def render(state: dict[str, Any], run_dir: str) -> str:
    lines: list[str] = []
    age = ""
    if state["last_ts"]:
        age = f"  last update {max(time.time() - state['last_ts'], 0.0):.1f}s ago"
    lines.append(
        f"run {state['run'] or '?'}  [{run_dir}]  "
        f"status={state['status']}  events={state['n_events']}{age}"
    )
    lines.append("")
    if state["n_steps"]:
        loss = state["loss"]
        lines.append(
            f"steps {state['last_step']}"
            + (f"  {state['steps_per_s']:.2f} steps/s"
               if state["steps_per_s"] else "")
            + (f"  {_fmt_rate(state['tokens_per_s'], 'tok/s')}"
               if state["tokens_per_s"] else "")
            + (f"  mfu {state['mfu']:.3f}" if state["mfu"] is not None else "")
            + (f"  loss {loss:.4f}" if isinstance(loss, (int, float)) else "")
        )
        spark = sparkline(state["losses"])
        if spark:
            finite = [
                v
                for v in state["losses"][-_LOSS_WINDOW:]
                if isinstance(v, (int, float)) and math.isfinite(v)
            ] or [0.0]
            lines.append(
                f"loss  {spark}  [{min(finite):.3f} .. {max(finite):.3f}]"
            )
    else:
        lines.append("steps (no step telemetry yet)")
    lines.append("")
    if state["devices"] or state["hbm_peak_bytes"]:
        lines.append("hbm watermarks:")
        for d in state["devices"]:
            # .get throughout: device_memory events are free-form (any
            # writer version, or hand-emitted) and the dashboard must
            # not die mid-watch on a missing field
            limit = d.get("bytes_limit") or 0
            peak = d.get("peak_bytes_in_use") or 0
            pct = (
                f"  ({100.0 * peak / limit:.0f}% of {_fmt_bytes(limit)})"
                if limit
                else ""
            )
            lines.append(
                f"  {d.get('device', '?'):12} "
                f"in-use {_fmt_bytes(d.get('bytes_in_use')):>10}"
                f"  peak {_fmt_bytes(peak):>10}{pct}"
            )
        if not state["devices"]:
            lines.append(f"  peak {_fmt_bytes(state['hbm_peak_bytes'])}")
        lines.append("")
    if state.get("alerts"):
        pairs = "  ".join(
            f"{k}={v}" for k, v in sorted(state["alerts"].items())
        )
        lines.append(f"ALERTS: {pairs}")
        last = state.get("last_alert") or {}
        detail = "  ".join(
            f"{k}={v}"
            for k, v in last.items()
            if k not in ("event", "ts", "run", "phase", "action")
            and v is not None
        )
        if detail:
            lines.append(f"  last: {last.get('action', '?')}  {detail}")
    if state["resilience"]:
        pairs = "  ".join(
            f"{k}={v}" for k, v in sorted(state["resilience"].items())
        )
        lines.append(f"resilience: {pairs}")
    if state.get("cluster"):
        pairs = "  ".join(
            f"{k}={v}" for k, v in sorted(state["cluster"].items())
        )
        lines.append(f"cluster: {pairs}")
    sv = state.get("serve") or {}
    if sv:
        head = "serving:"
        if sv.get("model"):
            head += f" {sv['model']}"
        if sv.get("port"):
            head += f" @ :{sv['port']}"
        if sv.get("version"):
            head += f"  model={sv['version']}"
        if sv.get("status"):
            head += f"  [{sv['status']}]"
        if isinstance(sv.get("cold_start_s"), (int, float)):
            head += f"  cold start {sv['cold_start_s']:.2f}s"
        if sv.get("swaps") or sv.get("rollbacks"):
            head += (
                f"  swaps={sv.get('swaps', 0)}"
                + (
                    f" rollbacks={sv['rollbacks']}"
                    if sv.get("rollbacks")
                    else ""
                )
            )
        lines.append(head)
        parts = []
        if sv.get("batches"):
            parts.append(
                f"{sv['batches']} batch(es)  {sv.get('rows', 0)} row(s)"
            )
            if isinstance(sv.get("batch_fill"), (int, float)):
                parts.append(f"fill {sv['batch_fill']:.2f}")
        if sv.get("generations"):
            parts.append(
                f"{sv['generations']} generation(s)  "
                f"{sv.get('tokens', 0)} tok"
            )
        if parts:
            lines.append("  " + "  ".join(parts))
    fl = state.get("fleet") or {}
    if fl:
        head = "fleet:"
        reps = fl.get("replicas") or {}
        if reps:
            up = sum(
                1 for r in reps.values() if r.get("state") == "up"
            )
            head += f" {up}/{len(reps)} up"
        counters = "  ".join(
            f"{k}={fl[k]}"
            for k in ("routed", "shed", "failover", "hedges")
            if fl.get(k) is not None
        )
        if counters:
            head += "  " + counters
        lines.append(head)
        for rid in sorted(reps, key=str):
            r = reps[rid]
            port = f" :{r['port']}" if r.get("port") else ""
            restarts = (
                f"  restarts={r['restarts']}" if r.get("restarts") else ""
            )
            lines.append(
                f"  r{rid}{port}  {r.get('state', '?')}{restarts}"
            )
        if fl.get("events"):
            lines.append(
                "  "
                + "  ".join(
                    f"{k.removeprefix('fleet_')}={v}"
                    for k, v in sorted(fl["events"].items())
                )
            )
    tn = state.get("tune") or {}
    if tn:
        head = "autotuner:"
        for k, v in sorted((tn.get("knobs") or {}).items()):
            head += f" {k}={v}"
        head += (
            f"  decisions={tn.get('decisions', 0)}"
            + (f" adjusts={tn['adjust']}" if tn.get("adjust") else "")
            + (f" reverts={tn['revert']}" if tn.get("revert") else "")
        )
        lines.append(head)
        last = tn.get("last")
        if last:
            detail = "  ".join(
                f"{k}={v}"
                for k, v in last.items()
                if k not in ("event", "ts", "run", "action", "knobs")
                and v is not None
            )
            lines.append(f"  last: {last.get('action', '?')}  {detail}")
    if state["plan_decisions"] or state.get("plan_streams"):
        parts = []
        if state["plan_decisions"]:
            parts.append(f"{state['plan_decisions']} decision(s)")
        if state.get("plan_streams"):
            parts.append(f"{state['plan_streams']} chunk stream(s)")
        lines.append("plan: " + "  ".join(parts))
    if state["trace_windows"]:
        lines.append(f"profiler: {state['trace_windows']} trace window(s)")
    return "\n".join(lines)


def resolve_run_dir(path: str) -> str:
    """Like :func:`events.resolve_run_dir` but also accepts a run that
    (so far) only has ``steps.jsonl`` — a crashed writer's run must
    still be inspectable."""
    try:
        return _events.resolve_run_dir(path)
    except (FileNotFoundError, NotADirectoryError):
        if os.path.isfile(os.path.join(path, _telemetry.STEPS_FILE)):
            return path
        candidates = [
            os.path.join(path, d)
            for d in (os.listdir(path) if os.path.isdir(path) else ())
            if os.path.isfile(os.path.join(path, d, _telemetry.STEPS_FILE))
        ]
        if not candidates:
            raise
        return max(candidates, key=os.path.getmtime)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    once = "--once" in argv
    if once:
        argv.remove("--once")
    interval = 2.0
    if "--interval" in argv:
        i = argv.index("--interval")
        if i + 1 >= len(argv):
            raise SystemExit("--interval needs a seconds argument")
        try:
            interval = float(argv[i + 1])
        except ValueError:
            raise SystemExit(
                f"--interval: bad seconds value {argv[i + 1]!r}"
            ) from None
        del argv[i : i + 2]
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit(
            "usage: python -m keystone_tpu_torch observe top <run-dir> "
            "[--once] [--interval S]\n"
            "<run-dir> is a directory containing steps.jsonl/events.jsonl,"
            "\nor a base KEYSTONE_OBSERVE_DIR — fleet mode: every LIVE\n"
            "run dir under it is tailed as one merged stream, and new\n"
            "ones (replica relaunches, rolling restarts) appear without\n"
            "a restart; with no live run, the newest finished one shows"
        )
    path = argv[0]
    fleet: FleetTails | None = None
    if os.path.isdir(path) and not any(
        os.path.isfile(os.path.join(path, f))
        for f in (_telemetry.STEPS_FILE, _events.EVENTS_FILE)
    ):
        # a BASE observe dir: fleet mode — tail every run dir under it
        # and keep rediscovering, so replicas relaunched mid-watch (a
        # rolling restart mints fresh run dirs) appear live
        fleet = FleetTails(path)
        fleet._discover()
        if not fleet._tails:
            try:
                resolve_run_dir(path)  # raise the canonical error
            except OSError as e:
                raise SystemExit(str(e)) from None
    if fleet is None:
        try:
            run_dir = resolve_run_dir(path)
        except OSError as e:
            raise SystemExit(str(e)) from None
        steps = Tail(os.path.join(run_dir, _telemetry.STEPS_FILE))
        events = Tail(os.path.join(run_dir, _events.EVENTS_FILE))
    while True:
        if fleet is not None:
            step_recs, event_recs = fleet.poll()
            label = f"{path} [{fleet.run_count} run dir(s)]"
        else:
            step_recs, event_recs = steps.poll(), events.poll()
            label = run_dir
        state = summarize(step_recs, event_recs)
        screen = render(state, label)
        if once:
            print(screen)
            return
        # ANSI clear + home: refresh in place without curses
        sys.stdout.write("\x1b[2J\x1b[H" + screen + "\n")
        sys.stdout.flush()
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return


if __name__ == "__main__":
    main()
