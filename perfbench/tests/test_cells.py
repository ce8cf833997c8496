"""Whole runs on the CPU at a small size (the look for a chip skipped): every
cell correct when sound, ``correct`` false under each fault the cell can
have, and a dummy cell and metric added from files alone."""

import json

import pytest

from perfbench import harness

from .conftest import REPO, cpu_opts, make_small_root

CELLS = tuple(w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"])
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(small_root, cell, trace):
    r = harness.run(small_root, cpu_opts(cell, trace=trace))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    names = set(r["metrics"])
    if trace:
        assert "device.launches_per_batch" in names
        assert "busy_s" in r["device"] and "breakdown" in r
    else:
        assert {"setup_s", "qps", "recall_at_10"} <= names
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_makes_the_run_incorrect(small_root, cell, fault):
    r = harness.run(small_root, cpu_opts(
        cell, fault=f"perfbench.tests.faults:{fault}"))
    assert not r["correct"], (fault, r["checks"])


def test_a_cell_and_a_metric_from_files_alone(tmp_path):
    root = make_small_root(tmp_path)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "sift1m-ivf.json").read_text())
    cfg.update(name="sift1m-flat", engine={"metric": "l2", "index": "flat"},
               guarantees={"recall_at_10_min": 1.0},
               limits={"dist_err": 5e-05})
    (pb / "configs" / "sift1m-flat.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "batch2k.json").write_text(json.dumps(
        {"batch": 32, "k": 10}))
    (pb / "metrics" / "dummy.batches.py").write_text(
        "def read(run):\n    return run.batches\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sift1m-flat", "source": "a test",
                             "file": "perfbench/configs/sift1m-flat.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "sift1m-flat.batch2k",
                               "config": "sift1m-flat", "traffic": "batch2k",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.batches", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "qps"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run(root, cpu_opts("sift1m-flat.batch2k", trace=1))
    assert r["correct"], r["checks"]
    assert r["metrics"]["dummy.batches"]["value"] >= 1
