"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name."""

import json
import re
from pathlib import Path
from typing import Dict, List

from perfbench.manifest import NAME, Manifest, system

from .conftest import REPO

UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def problems(root: Path) -> List[str]:
    """What in the manifest breaks the benchmark's contract (empty: none)."""
    m = Manifest(root)
    d, out = m.data, []
    if set(d) != TOP_KEYS:
        out.append(f"top-level keys {sorted(d)}")
    names: Dict[str, int] = {}

    def name_ok(kind, n):
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{kind} name {n!r}")

    def line_ok(kind, s):
        if not isinstance(s, str) or not 1 <= len(s) <= 200 \
                or "\n" in s or "\t" in s:
            out.append(f"{kind} {s!r}")

    for p in d["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    for c in d["configs"]:
        if set(c) != CONFIG_KEYS:
            out.append(f"config keys {sorted(c)}")
        name_ok("config", c["name"])
        line_ok("source", c["source"])
        line_ok("why", c["why"])
        for key in c["reduced"]:
            name_ok("reduced key", key)
        if not (root / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
        names[c["name"]] = names.get(c["name"], 0) + 1
    for w in d["workloads"]:
        if set(w) != WORKLOAD_KEYS:
            out.append(f"workload keys {sorted(w)}")
        for key in ("name", "config", "traffic"):
            name_ok(f"workload {key}", w[key])
        line_ok("why", w["why"])
        if w["config"] not in m.configs:
            out.append(f"workload {w['name']}: no config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
        if not m.traffic_path(w["traffic"]).is_file():
            out.append(f"traffic file for {w['traffic']} missing")
    metric_names = []
    for kind, keys in (("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        for x in d[kind]:
            if set(x) - {"workloads"} != keys:
                out.append(f"{kind} {x.get('name')} keys {sorted(x)}")
            name_ok("metric", x["name"])
            metric_names.append(x["name"])
            if not UNIT.match(x["unit"]):
                out.append(f"unit {x['unit']!r}")
            if x["better"] not in ("lower", "higher"):
                out.append(f"better {x['better']!r}")
            for cell in x.get("workloads", []):
                if cell not in m.cells:
                    out.append(f"{x['name']}: no workload {cell}")
            if not m.metric_path(x["name"]).is_file():
                out.append(f"metric reader {x['name']} missing")
            if kind == "per_layer":
                line_ok("layer", x["layer"])
    if len(set(metric_names)) != len(metric_names):
        out.append("metric names repeat")
    if len(m.cells) != len(d["workloads"]):
        out.append("workload names repeat")
    if any(v > 1 for v in names.values()):
        out.append("config names repeat")
    return out


def test_manifest_loads_and_keeps_the_contract():
    assert problems(REPO) == []


def test_every_file_is_found_by_name():
    m = Manifest(REPO)
    for cell in m.data["workloads"]:
        assert m.traffic_path(cell["traffic"]).is_file()
        cfg = m.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert system(cfg["system"]).build
    for metric in m.data["end_to_end"] + m.data["per_layer"]:
        assert hasattr(m.reader(metric["name"]), "read")


def test_each_layer_metric_cell_reports_what_it_moves():
    m = Manifest(REPO)
    for metric in m.data["per_layer"]:
        for cell in metric.get("workloads", m.cells):
            e2e = {x["name"] for x in m.metrics_of(cell, trace=False)}
            assert metric["moves"] in e2e, (metric["name"], cell)
            assert metric in m.metrics_of(cell, trace=True)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    m = Manifest(REPO)
    for cell in m.cells:
        e2e = {x["name"] for x in m.metrics_of(cell, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics_of(cell, trace=True)


def test_bounds_and_chips():
    d = json.loads((REPO / "BENCHMARK.json").read_text())
    for x in d["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    four = [w for w in d["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(d["workloads"]) // 4)
    assert 1 <= d["run_seconds"] <= 51
    for c in d["configs"]:
        assert any(w["config"] == c["name"] for w in d["workloads"])
