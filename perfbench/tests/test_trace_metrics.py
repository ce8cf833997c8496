"""The per-layer metrics that read the program's spans, on a synthetic span
summary: each reading, and no reading where the run was not traced, the
program has no tracer, or spans were dropped."""

import sys
from types import SimpleNamespace

import pytest

import repro_torch
from perfbench.manifest import Manifest
from repro_torch import tracing

from .conftest import REPO

READERS = ("engine.host_ms_per_batch", "engine.wait_ms_per_batch",
           "hnsw.host_ms_per_step", "hnsw.fresh_slot_share",
           "hnsw.active_query_share", "ivf.host_ms_per_batch")


def _agg(n, s, wait_s=0.0, **counts):
    return {"n": n, "s": s, "wait_s": wait_s, "counts": counts}


#: four batches: 2.0 s in engine.search with 0.4 s of waits, 0.1 s of them
#: the engine's copies; 40 steps of 1.0 s with 0.2 s of syncs; 0.8 s in IVF
SUMMARY = {"spans": {
    "engine.search": _agg(4, 2.0, 0.4, queries=4096, k=40, route_index=4),
    "engine.to_host": _agg(4, 0.1, 0.1, bytes=4096),
    "hnsw.step": _agg(40, 1.0, 0.2, queries=40960, active=30720,
                      slots=40960 * 128, fresh=1310720),
    "ivf.search": _agg(4, 0.8, 0.0, queries=4096, lists=4096 * 32)},
    "wait_s": 0.4, "recorded": 92, "dropped": 0}

EXPECT = {"engine.host_ms_per_batch": 400.0,
          "engine.wait_ms_per_batch": 100.0,
          "hnsw.host_ms_per_step": 20.0,
          "hnsw.fresh_slot_share": 25.0,
          "hnsw.active_query_share": 75.0,
          "ivf.host_ms_per_batch": 200.0}


def _run(trace=True):
    return SimpleNamespace(trace={"busy_s": 1.0, "window_s": 10.0}
                           if trace else None, batches=4)


@pytest.fixture
def readers():
    m = Manifest(REPO)
    return {name: m.reader(name) for name in READERS}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_on_a_summary(readers, monkeypatch, name):
    monkeypatch.setattr(tracing, "summary", lambda: SUMMARY)
    assert readers[name].read(_run()) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", READERS)
def test_no_reading_without_a_whole_traced_window(readers, monkeypatch,
                                                  name):
    monkeypatch.setattr(tracing, "summary", lambda: SUMMARY)
    assert readers[name].read(_run(trace=False)) is None
    monkeypatch.setattr(tracing, "summary",
                        lambda: dict(SUMMARY, dropped=1))
    assert readers[name].read(_run()) is None
    monkeypatch.setattr(tracing, "summary",
                        lambda: dict(SUMMARY, spans={}))
    assert readers[name].read(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_no_reading_from_a_program_without_the_tracer(readers, monkeypatch,
                                                      name):
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert readers[name].read(_run()) is None
