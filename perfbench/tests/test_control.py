"""The control on the card: the reference in the program's place with TF32
products comes out as not correct.  The card's own command for it:

    python3 perfbench/control.py --workload <cell> --seed <n> --seconds 10

(the readings that set each limit's upper end); here a small copy of each
cell.  TF32 exists only on the card, so on the CPU this skips."""

import json

import pytest
import torch

from perfbench import harness

from .conftest import REPO, cpu_opts


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_control_is_not_correct(small_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need a CUDA card")
    opts = cpu_opts(cell, seconds=2.0, system="control")
    opts["device"] = "cuda"
    r = harness.run(small_root, opts)
    assert not r["correct"], r["checks"]
    assert r["checks"]["dist_err"]["value"] > r["checks"]["dist_err"]["limit"]
