"""Shared helpers of the benchmark's CPU tests: a small copy of the
benchmark's root (the same configurations, traffic and metric files, with
the corpora, the pools and the batches cut to what a CPU test can hold)."""

import json
import shutil
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "perfbench"


def make_small_root(tmp: Path, rows: int = 3000, queries: int = 300,
                    batch: int = 64) -> Path:
    """A root holding BENCHMARK.json and perfbench's data and metric files,
    at small sizes (IVF at nlist 16, nprobe 4)."""
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(PKG / sub, tmp / "perfbench" / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg["rows"], cfg["queries"] = rows, queries
        if "ivf" in cfg.get("engine", {}):
            cfg["engine"]["ivf"] = {"nlist": 16, "nprobe": 4}
        path.write_text(json.dumps(cfg))
    for w in (tmp / "perfbench" / "workloads").glob("*.json"):
        mix = json.loads(w.read_text())
        mix["batch"] = batch
        w.write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cpu_opts(cell: str, seed: int = 5, seconds: float = 1.0, trace: int = 0,
             **extra) -> dict:
    """A run's options on the CPU, the look for a chip skipped."""
    opts = dict(workload=cell, seed=seed, seconds=seconds, trace=trace,
                t_start=time.perf_counter(), device="cpu")
    opts.update(extra)
    return opts


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return make_small_root(tmp_path_factory.mktemp("bench"))
