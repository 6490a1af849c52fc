"""``observe serve`` — the live fleet dashboard over a collector dir.

The port's copy of ``keystone_tpu/observe/dashboard.py``, its imports pointed at
``keystone_tpu_torch``.

A stdlib HTTP server that turns the collector's output directory into
the tier's single pane: fleet timelines (range queries over the
time-series store rendered as sparklines), the SLO burn-rate table with
FIRING markers and their trace exemplars, the merged alert feed, and a
federation ``/metrics`` endpoint external scrapers can ingest (the
collector's last-good merged exposition).

Endpoints::

    GET /                 HTML dashboard (auto-refreshing, no deps)
    GET /api/series       {"series": [names...]}
    GET /api/query?series=S[&start=T][&end=T][&limit=N]   range query
    GET /api/slo          {"objectives": [verdicts...]}   live evaluation
    GET /api/summary      one call the dashboard page polls: slo +
                          alerts + targets + series
    GET /metrics          federation exposition (text 0.0.4)

Everything is read-only over the collector's files — run it anywhere
that can see the directory (the collector host, a laptop over NFS); it
never contends with the collector's writer.

Usage: ``python -m keystone_tpu_torch observe serve <dir> [--port N]``.
"""

from __future__ import annotations

import json
import os
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from keystone_tpu_torch.observe import slo as _slo
from keystone_tpu_torch.observe.collector import FEDERATION_FILE, TARGETS_FILE
from keystone_tpu_torch.observe.timeseries import TimeSeriesStore

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>keystone fleet</title>
<style>
 body { font: 13px/1.5 monospace; background: #101418; color: #d6dde4;
        margin: 2em; }
 h1 { font-size: 15px; } h2 { font-size: 13px; color: #8fa3b0; }
 .firing { color: #ff6b6b; font-weight: bold; }
 .ok { color: #69db7c; }
 td, th { padding: 0 12px 0 0; text-align: left; }
 .spark { color: #74c0fc; }
 #err { color: #ffa94a; }
</style></head><body>
<h1>keystone fleet observability</h1>
<div id="err"></div>
<h2>SLO burn rates</h2><table id="slo"></table>
<h2>timelines</h2><div id="lines"></div>
<h2>alerts (newest last)</h2><pre id="alerts"></pre>
<h2>scrape targets</h2><pre id="targets"></pre>
<script>
const BARS = "\\u2581\\u2582\\u2583\\u2584\\u2585\\u2586\\u2587\\u2588";
// series names, exemplar ids, and alert actions come from SCRAPED
// data — a hostile target's label values must render as text, never
// as markup in the operator's browser
function esc(s) {
  return String(s).replace(/&/g, "&amp;").replace(/</g, "&lt;")
    .replace(/>/g, "&gt;").replace(/"/g, "&quot;");
}
function spark(vals) {
  if (!vals.length) return "";
  const lo = Math.min(...vals), hi = Math.max(...vals);
  const span = (hi - lo) || 1;
  return vals.map(v => BARS[Math.round((v - lo) / span * 7)]).join("");
}
async function refresh() {
  try {
    const s = await (await fetch("/api/summary")).json();
    const slo = document.getElementById("slo");
    slo.innerHTML = "<tr><th>objective</th><th>speed</th>" +
      "<th>burn(short)</th><th>burn(long)</th><th>factor</th>" +
      "<th>n</th><th>status</th></tr>";
    for (const v of s.slo) {
      const row = slo.insertRow();
      const status = v.firing
        ? `FIRING${v.exemplar_rid !== undefined
            ? " rid=" + v.exemplar_rid : ""}${v.exemplar_trace
            ? " trace=" + v.exemplar_trace : ""}`
        : "ok";
      row.innerHTML = `<td>${esc(v.objective)}</td><td>${esc(v.speed)}</td>` +
        `<td>${esc(v.burn_short)}</td><td>${esc(v.burn_long)}</td>` +
        `<td>${esc(v.factor)}</td><td>${esc(v.total)}</td>` +
        `<td class="${v.firing ? "firing" : "ok"}">${esc(status)}</td>`;
    }
    const lines = document.getElementById("lines");
    lines.textContent = "";
    for (const name of s.timeline_series) {
      // bounded to the slow SLO window: an unbounded query would make
      // the server re-parse the whole retention on every 2s refresh
      const start = Date.now() / 1000 - 21600;
      const q = await (await fetch(
        "/api/query?limit=120&start=" + start +
        "&series=" + encodeURIComponent(name))).json();
      const vals = q.points.map(p => p.value);
      const last = vals.length ? vals[vals.length - 1] : "-";
      const div = document.createElement("div");
      div.innerHTML = `${esc(name.padEnd(28))} <span class="spark">` +
        `${spark(vals)}</span>  ${esc(typeof last === "number"
          ? last.toPrecision(4) : last)} (${vals.length} pts)`;
      lines.appendChild(div);
    }
    document.getElementById("alerts").textContent = s.alerts.map(a =>
      `${new Date(a.ts * 1000).toISOString()}  ${a.action || a.state || "?"}` +
      `  ${a.state || ""}${a.exemplar_rid !== undefined
        ? "  rid=" + a.exemplar_rid : ""}`).join("\\n") || "(none)";
    document.getElementById("targets").textContent =
      Object.entries(s.targets).map(([t, st]) =>
        `${st.up ? "up  " : "DOWN"}  ${t}${st.error
          ? "  " + st.error : ""}`).join("\\n") || "(none)";
    document.getElementById("err").textContent = "";
  } catch (e) { document.getElementById("err").textContent = String(e); }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""

#: series the dashboard's timeline panel plots by default (plus every
#: ``slo.*`` family found in the store)
DEFAULT_TIMELINES = (_slo.REQUEST_SERIES, _slo.GOODPUT_SERIES, "train.loss")


def _handler_for(out_dir: str, slo_config: _slo.SLOConfig | None):
    store = TimeSeriesStore(_slo.resolve_store_dir(out_dir))
    base_dir = (
        out_dir
        if os.path.isdir(os.path.join(out_dir, "tsdb"))
        else os.path.dirname(out_dir.rstrip("/")) or out_dir
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — keep quiet
            pass

        def _send_json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self._send_bytes(code, body, "application/json")

        def _send_bytes(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — stdlib API
            parsed = urllib.parse.urlsplit(self.path)
            path = parsed.path
            qs = urllib.parse.parse_qs(parsed.query)
            try:
                if path == "/":
                    return self._send_bytes(
                        200, _PAGE.encode(), "text/html; charset=utf-8"
                    )
                if path == "/api/series":
                    return self._send_json(
                        200, {"series": store.series_names()}
                    )
                if path == "/api/query":
                    return self._query(qs)
                if path == "/api/slo":
                    return self._send_json(200, {"objectives": self._slo()})
                if path == "/api/summary":
                    return self._summary()
                if path == "/metrics":
                    return self._federation()
            except Exception as e:  # noqa: BLE001 — the pane must answer
                return self._send_json(500, {"error": repr(e)})
            return self._send_json(
                404,
                {
                    "error": f"unknown path {path}",
                    "paths": [
                        "/", "/api/series", "/api/query", "/api/slo",
                        "/api/summary", "/metrics",
                    ],
                },
            )

        def _query(self, qs: dict) -> None:
            series = (qs.get("series") or [None])[0]
            if not series:
                return self._send_json(
                    400, {"error": "series parameter required"}
                )

            def _f(key):
                raw = (qs.get(key) or [None])[0]
                return float(raw) if raw else None

            limit = int((qs.get("limit") or ["500"])[0])
            points = store.query(
                series, start=_f("start"), end=_f("end"), limit=limit
            )
            return self._send_json(
                200, {"series": series, "points": points}
            )

        def _slo(self) -> list[dict]:
            engine = _slo.SLOEngine(store, slo_config, emit=False)
            return engine.evaluate()

        def _summary(self) -> None:
            names = store.series_names()
            # default panels first, then every burn-rate gauge the
            # collector persists per (objective, speed) pair
            timelines = [
                n
                for n in DEFAULT_TIMELINES
                if n in names
            ] + [n for n in names if n.startswith("slo_burn{")]
            # alert feeds bounded to the slow window: the segment-span
            # index can then skip everything older without parsing it
            horizon = time.time() - 21600
            alerts = store.query(_slo.ALERT_SERIES, start=horizon, limit=10)
            alerts += store.query("alerts", start=horizon, limit=10)
            alerts.sort(key=lambda r: r.get("ts") or 0)
            targets = {}
            tpath = os.path.join(base_dir, TARGETS_FILE)
            if os.path.isfile(tpath):
                try:
                    with open(tpath) as f:
                        targets = json.load(f)
                except (OSError, ValueError):
                    targets = {}
            return self._send_json(
                200,
                {
                    "ts": time.time(),
                    "slo": self._slo(),
                    "alerts": alerts[-12:],
                    "targets": targets,
                    "series": names,
                    "timeline_series": timelines,
                },
            )

        def _federation(self) -> None:
            fpath = os.path.join(base_dir, FEDERATION_FILE)
            body = b""
            if os.path.isfile(fpath):
                try:
                    with open(fpath, "rb") as f:
                        body = f.read()
                except OSError:
                    body = b""
            return self._send_bytes(
                200, body, "text/plain; version=0.0.4; charset=utf-8"
            )

    return Handler


def serve(
    out_dir: str,
    port: int = 8200,
    host: str = "127.0.0.1",
    slo_config: _slo.SLOConfig | None = None,
) -> ThreadingHTTPServer:
    """Bind the dashboard server (caller runs ``serve_forever``); port 0
    asks the OS — read the bound port off ``server_address``."""
    return ThreadingHTTPServer(
        (host, port), _handler_for(out_dir, slo_config)
    )


def main(argv: list[str] | None = None) -> None:
    """``python -m keystone_tpu_torch observe serve <dir> [--port N]
    [--host H] [--config FILE]``."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    port, host, config = 8200, "127.0.0.1", None
    for flag in ("--port", "--host", "--config"):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} needs a value")
            val = argv[i + 1]
            if flag == "--port":
                try:
                    port = int(val)
                except ValueError:
                    raise SystemExit(f"--port: bad port {val!r}") from None
            elif flag == "--host":
                host = val
            else:
                config = _slo.SLOConfig.from_file(val)
            del argv[i : i + 2]
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit(
            "usage: python -m keystone_tpu_torch observe serve <dir> "
            "[--port N] [--host H] [--config FILE]\n"
            "<dir> is a collector output directory (contains tsdb/,\n"
            "federation.prom); serves the live fleet dashboard, range-\n"
            "query API, SLO verdicts, and federation /metrics"
        )
    try:
        _slo.resolve_store_dir(argv[0])
    except OSError as e:
        raise SystemExit(str(e)) from None
    httpd = serve(argv[0], port=port, host=host, slo_config=config)
    bound = httpd.server_address[1]
    print(
        f"fleet dashboard for {argv[0]!r} on http://{host}:{bound}",
        flush=True,
    )
    try:
        httpd.serve_forever(poll_interval=0.1)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
