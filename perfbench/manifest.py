"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``perfbench/workloads/<traffic>.json``;
- a metric: ``perfbench/metrics/<name>.py``, a reader with ``read(run)``;
- a system driver: ``perfbench.systems.<system>`` (``systems/<system>.py``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
PKG = "perfbench"


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.configs[name]["file"])
                          .read_text())

    def traffic_path(self, traffic: str) -> Path:
        return self.root / PKG / "workloads" / f"{traffic}.json"

    def traffic(self, traffic: str) -> dict:
        return json.loads(self.traffic_path(traffic).read_text())

    def metric_path(self, name: str) -> Path:
        return self.root / PKG / "metrics" / f"{name}.py"

    def metrics_of(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        ones: those whose ``workloads`` list it, or every cell where a
        metric has none (a per-layer one: every cell that reports the
        end-to-end metric it moves)."""
        e2e = [m for m in self.data["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell]) and m["moves"] in names]

    def reader(self, name: str):
        """The metric's reader module, loaded from its file."""
        path = self.metric_path(name)
        spec = importlib.util.spec_from_file_location(
            f"{PKG}_metric_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def system(name: str):
    if not NAME.match(name):
        raise ValueError(f"bad system name {name!r}")
    return importlib.import_module(f"{PKG}.systems.{name}")
