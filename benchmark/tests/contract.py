"""The benchmark's contract on ``BENCHMARK.json``, checked by the tests:
names, units, lengths, keys, and every entry's files found by name."""

from __future__ import annotations

import os
import re

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def problems(bench: dict, root: str | None = None) -> list[str]:
    """The ways ``bench`` breaks the benchmark's contract on names, units,
    lengths and references between entries (empty when it keeps it)."""
    out: list[str] = []

    def line(text, what, limit=200):
        if not isinstance(text, str) or not 1 <= len(text) <= limit or "\n" in text or "\t" in text:
            out.append(f"{what}: not 1-{limit} characters on one line: {text!r}")

    def name(text, what):
        if not isinstance(text, str) or not NAME.match(text):
            out.append(f"{what}: bad name {text!r}")

    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(bench) != keys:
        out.append(f"top-level keys {sorted(bench)} != {sorted(keys)}")
    cmd = bench.get("command", [])
    if not 1 <= len(cmd) <= 32:
        out.append("command: 1-32 words")
    for word in cmd:
        line(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            out.append(f"command word {word!r} leads out of the checkout")
    paths = bench.get("paths", [])
    if not 1 <= len(paths) <= 16:
        out.append("paths: 1-16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    rs = bench.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        out.append(f"run_seconds {rs!r} not a whole number in 1-51")

    configs = bench.get("configs", [])
    if not 1 <= len(configs) <= 24:
        out.append("configs: 1-24")
    conf_names = set()
    for c in configs:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c.get('name')}: keys {sorted(c)}")
        name(c.get("name"), "config name")
        conf_names.add(c.get("name"))
        line(c.get("source"), f"config {c.get('name')} source")
        line(c.get("why"), f"config {c.get('name')} why")
        if not any(c.get("file", "").startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config {c.get('name')}: file outside paths")
        if len(c.get("reduced", [])) > 16:
            out.append(f"config {c.get('name')}: more than 16 reduced keys")
        for k in c.get("reduced", []):
            name(k, f"config {c.get('name')} reduced key")
        if root is not None and not os.path.isfile(os.path.join(root, c.get("file", ""))):
            out.append(f"config {c.get('name')}: no file {c.get('file')}")
    if len(conf_names) != len(configs):
        out.append("two configs share a name")

    work = bench.get("workloads", [])
    if not 1 <= len(work) <= 24:
        out.append("workloads: 1-24")
    pairs, cells, used = set(), set(), set()
    for w in work:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w.get('name')}: keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            name(w.get(k), f"workload {k}")
        line(w.get("why"), f"workload {w.get('name')} why")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        if w.get("config") not in conf_names:
            out.append(f"workload {w.get('name')}: unknown config {w.get('config')}")
        used.add(w.get("config"))
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w.get('name')}: config and traffic appear twice")
        pairs.add(pair)
        cells.add(w.get("name"))
        if root is not None and not os.path.isfile(spec.traffic_path(root, w.get("traffic", ""))):
            out.append(f"workload {w.get('name')}: no traffic file for {w.get('traffic')}")
        if root is not None and not os.path.isfile(spec.limits_path(root, w.get("name", ""))):
            out.append(f"workload {w.get('name')}: no limits file")
    if len(cells) != len(work):
        out.append("two workloads share a name")
    if conf_names - used:
        out.append(f"configs used by no cell: {sorted(conf_names - used)}")

    e2e = bench.get("end_to_end", [])
    per = bench.get("per_layer", [])
    if not 1 <= len(e2e) <= 16:
        out.append("end_to_end: 1-16")
    if not 1 <= len(per) <= 128:
        out.append("per_layer: 1-128")
    metric_names = set()
    for m in e2e + per:
        name(m.get("name"), "metric name")
        if m.get("name") in metric_names:
            out.append(f"metric {m.get('name')} appears twice")
        metric_names.add(m.get("name"))
        if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
            out.append(f"metric {m.get('name')}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m.get('name')}: better {m.get('better')!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"metric {m.get('name')}: unknown cell {c}")
    e2e_names = set()
    for m in e2e:
        e2e_names.add(m.get("name"))
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        if not set(m) <= allowed or not {"name", "unit", "better", "bound", "source"} <= set(m):
            out.append(f"end-to-end metric {m.get('name')}: keys {sorted(m)}")
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"end-to-end metric {m.get('name')}: source {m.get('source')}")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            out.append(f"end-to-end metric {m.get('name')}: bound {b!r}")
    if "setup_s" not in e2e_names:
        out.append("no setup_s")
    for m in per:
        allowed = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if not set(m) <= allowed or not allowed - {"workloads"} <= set(m):
            out.append(f"per-layer metric {m.get('name')}: keys {sorted(m)}")
        if m.get("source") not in ("device_trace", "program_span", "program_counter", "host_clock"):
            out.append(f"per-layer metric {m.get('name')}: source {m.get('source')}")
        if m.get("moves") not in e2e_names or m.get("moves") == "setup_s":
            out.append(f"per-layer metric {m.get('name')}: moves {m.get('moves')}")
        line(m.get("layer"), f"per-layer metric {m.get('name')} layer")
        if root is not None and not os.path.isfile(spec.metric_path(root, m.get("name", ""))):
            out.append(f"per-layer metric {m.get('name')}: no reader file")
    return out
