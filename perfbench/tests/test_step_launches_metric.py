"""hnsw.step_launches_per_batch on synthetic counters: B1ˢ's launches over
the window's batches, and no reading from a program without its counter."""

from types import SimpleNamespace

import pytest

from perfbench.manifest import Manifest

from .conftest import REPO


@pytest.mark.parametrize("counters,expect", [
    # B1ˢ once a step over four batches, B1 once a batch beside it
    ({"beam_gather.step_launches": 332, "beam_gather.launches": 4}, 83.0),
    # a program without B1ˢ's counter (the plain step): no reading
    ({"beam_gather.launches": 336}, None),
    ({"beam_gather.step_launches": 0}, None)])
def test_step_launches_per_batch_reads_the_counter(counters, expect):
    reader = Manifest(REPO).reader("hnsw.step_launches_per_batch")
    run = SimpleNamespace(counters=counters, batches=4, trace=None)
    assert reader.read(run) == (None if expect is None
                                else pytest.approx(expect))
