"""The port's spans (``repro_torch.tracing``) on its search path.

On the CPU: with the profiler off nothing is recorded and no profiler range
is opened; under a CPU ``torch.profiler`` each search forms one span tree
(one request id, parents set), each thread keeps its own stack; results and
the aten ops the search runs are those of the untraced search but for the
HNSW loop's fresh-slot count; the counts repeat the search's own iteration
counters and the host oracle's fresh blocks exactly.

Marked ``cuda`` (skips without a card; this file imports no JAX): on the
card each span lies on its profiler twin's clock, and no device operation
of a traced window bears a span's name.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace.py
"""

import collections
import statistics
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.core import (EngineConfig, HNSWConfig, IVFConfig,
                              QuantixarEngine, bulk_build_device)
from repro_torch.core.hnsw_build import preprocess_vectors
from repro_torch.core.hnsw_search import (search, search_numpy_reference,
                                          to_device)
from repro_torch.data.synthetic import gaussian_mixture

N, DIM = 1500, 24
INDEXES = ("hnsw", "ivf")
#: the ops the HNSW loop adds while recording: the fresh slots' sum, its
#: accumulation, and the one read of the total
COUNT_OPS = {"aten.sum.default", "aten.add_.Tensor",
             "aten._local_scalar_dense.default"}


def _engine(index, device="cpu", n=N, dim=DIM):
    x = gaussian_mixture(n, dim, n_clusters=15, scale=0.25, seed=3)
    cfg = EngineConfig(dim=dim, metric="cosine", index=index,
                       builder="bulk", hnsw=HNSWConfig(M=8),
                       ivf=IVFConfig(nlist=16, nprobe=4))
    eng = QuantixarEngine(cfg, device=device)
    eng.add(x)
    eng.build()
    return eng


@pytest.fixture(scope="module", params=INDEXES)
def engine(request):
    return _engine(request.param)


@pytest.fixture(scope="module")
def queries():
    return gaussian_mixture(40, DIM, n_clusters=15, scale=0.25, seed=11)


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    """fn() under a profiler: (its result, the tracer's spans, the
    profiler)."""
    tracing.clear()
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, tracing.spans(), prof


def _check_trees(spans, n_requests):
    """Each request: one root ``engine.search``, every other span's parent
    in the request, on the request's one thread."""
    by_id = {s.span_id: s for s in spans}
    reqs = collections.defaultdict(list)
    for s in spans:
        reqs[s.request].append(s)
    assert len(reqs) == n_requests
    for members in reqs.values():
        roots = [s for s in members if s.parent == 0]
        assert [r.name for r in roots] == ["engine.search"]
        assert len({s.thread for s in members}) == 1
        for s in members:
            up = s
            while up.parent:
                up = by_id[up.parent]
                assert up.request == s.request
                assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
            assert up is roots[0]


def test_off_records_nothing_and_opens_no_range(engine, queries,
                                                monkeypatch):
    def no_twin(name):
        raise AssertionError(f"profiler range {name} opened while off")

    monkeypatch.setattr(tracing, "_twin", no_twin)
    tracing.clear()
    assert not torch.autograd._profiler_enabled()
    with tracing.span("engine.search") as sp:
        assert sp is tracing.span("hnsw.step") and not sp
    engine.search(queries, 10)
    assert tracing.spans() == [] and tracing.summary()["recorded"] == 0


def test_each_search_is_one_span_tree(engine, queries):
    _, spans, prof = _traced(
        lambda: [engine.search(queries[i::3], 10) for i in range(3)])
    _check_trees(spans, 3)
    assert tracing.summary()["dropped"] == 0
    # every span has its profiler twin of the same name
    twins = collections.Counter(e.name() for e in
                                prof.profiler.kineto_results.events())
    for name, n in collections.Counter(s.name for s in spans).items():
        assert twins[name] == n, name
    index = engine.config.index
    names = {s.name for s in spans}
    assert {"engine.search", "engine.index", "engine.to_host"} <= names
    assert {f"{index}.search" if index == "ivf" else "hnsw.step"} <= names


def test_stacks_are_thread_local(engine, queries, monkeypatch):
    """Two threads search at once.  A profiler records only the thread that
    starts it, so the switch is forced on here in both."""
    monkeypatch.setattr(tracing, "_enabled", lambda: True)
    tracing.clear()
    start = threading.Barrier(2)
    errors = []

    def worker(part):
        try:
            start.wait(timeout=30)
            for i in range(3):
                engine.search(queries[part::2][i::3], 10)
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(p,))
                   for p in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = tracing.spans()
    _check_trees(spans, 6)
    assert len({s.thread for s in spans}) == 2


def test_results_are_bit_identical_on_and_off(engine, queries):
    d0, i0 = engine.search(queries, 10)
    (d1, i1), spans, _ = _traced(lambda: engine.search(queries, 10))
    assert spans
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten":
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _AtenOps() as mode:
        fn()
    return mode.ops


def test_spans_add_only_the_count_ops(engine, queries):
    def run():
        engine.search(queries, 10)

    off = _ops(run)
    on, spans, _ = _traced(lambda: _ops(run))
    steps = sum(s.name == "hnsw.step" for s in spans)
    # the off list is the on list without the count ops
    extra, j = [], 0
    for op in on:
        if j < len(off) and op == off[j]:
            j += 1
        else:
            extra.append(op)
    assert j == len(off)
    assert set(extra) <= COUNT_OPS
    if engine.config.index == "ivf":
        assert extra == [] and on == off
    else:
        assert steps > 0 and len(extra) <= 2 * steps


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("width", [1, 4])
def test_counts_repeat_the_search_and_the_oracle(queries, metric, width):
    x = gaussian_mixture(N, DIM, n_clusters=15, scale=0.25, seed=3)
    packed = bulk_build_device(x, HNSWConfig(M=8, metric=metric, seed=0),
                               device="cpu")
    g, max_level, m = to_device(packed, "cpu")
    q = torch.as_tensor(preprocess_vectors(queries, metric))
    (d, ids, iters), spans, _ = _traced(
        lambda: search(g, q, k=10, ef=32, max_level=max_level, metric=m,
                       expansion_width=width, with_iters=True))
    blocks = []
    _, ids_ref = search_numpy_reference(packed, queries, 10, 32,
                                        expansion_width=width,
                                        block_sizes=blocks)
    # the counts are compared where the oracle walks the same path
    np.testing.assert_array_equal(ids.numpy(), ids_ref)
    steps = [s for s in spans if s.name == "hnsw.step"]
    assert len(steps) == int(iters.max())
    total = collections.Counter()
    for s in steps:
        total.update(s.counts)
    nq, m0 = q.shape[0], g.adj0.shape[1]
    assert total["active"] == int(iters.sum())
    assert total["queries"] == nq * len(steps)
    assert total["slots"] == nq * width * m0 * len(steps)
    assert total["fresh"] == sum(blocks)
    # one sync a step, one before the first, and the descent's
    by_id = {s.span_id: s for s in spans}
    waits = [s for s in spans if s.name == "hnsw.wait"]
    in_steps = [s for s in waits if by_id.get(s.parent, s).name ==
                "hnsw.step"]
    descent = [s for s in spans if s.name == "hnsw.descent"]
    assert len(in_steps) == len(steps)
    assert len(waits) == len(steps) + 1 + descent[0].counts.get(
        "iters", 0) + max_level
    assert all(s.wait for s in waits)
    summ = tracing.summary()
    step = summ["spans"]["hnsw.step"]
    assert step["wait_s"] == pytest.approx(
        sum((s.end_ns - s.start_ns) / 1e9 for s in in_steps))


def test_summary_and_a_full_buffer(monkeypatch):
    monkeypatch.setattr(tracing, "_enabled", lambda: True)
    monkeypatch.setattr(tracing, "MAX_SPANS", 4)
    tracing.clear()
    with tracing.span("a", n=1) as a:
        with tracing.span("w", wait=True):
            with tracing.span("w2", wait=True):
                pass
        a.count(n=2)
    for _ in range(2):
        with tracing.span("a", n=1):
            pass
    s = tracing.summary()
    assert s["dropped"] == 1 and s["recorded"] == 4
    assert s["spans"]["a"]["n"] == 2 and s["spans"]["a"]["counts"] == {"n": 4}
    # a wait inside a wait counts once, as the outer one
    w = s["spans"]["w"]
    assert s["wait_s"] == pytest.approx(w["s"])
    assert s["spans"]["w2"]["wait_s"] == 0.0
    assert s["spans"]["a"]["wait_s"] == pytest.approx(w["s"])
    assert len({x.request for x in tracing.spans()}) == 2
    # a recording starts empty after a span site found the profiler off
    monkeypatch.setattr(tracing, "_enabled", lambda: False)
    tracing.span("x")
    monkeypatch.setattr(tracing, "_enabled", lambda: True)
    with tracing.span("b"):
        pass
    assert [x.name for x in tracing.spans()] == ["b"]
    assert tracing.summary()["dropped"] == 0


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the search's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("index", INDEXES)
def test_spans_meet_their_twins_on_the_card(cuda, index):
    from repro_torch.kernels import beam_gather as bg_mod

    eng = _engine(index, device=cuda, n=20_000, dim=128)
    q = gaussian_mixture(1024, 128, n_clusters=15, scale=0.25, seed=11)
    eng.search(q, 10)                               # first use
    torch.cuda.synchronize()
    b1 = bg_mod.launches
    _, spans, prof = _traced(lambda: eng.search(q, 10),
                             (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    torch.cuda.synchronize()
    if index == "hnsw":
        steps = sum(s.name == "hnsw.step" for s in spans)
        assert steps == bg_mod.launches - b1 - 1 > 0
    names = {s.name for s in spans}
    host = collections.defaultdict(list)
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() in names:
                host[e.name()].append((e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            device.append(e.name())
    # no kernel, copy or set bears a span's name
    assert device and not names & set(device)
    starts, ends = [], []
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        twins = sorted(host[name])
        assert len(twins) == len(mine), name
        for (a, b), (ta, tb) in zip(mine, twins):
            starts.append(abs(a - ta))
            ends.append(abs(b - tb))
    assert statistics.median(starts) < 50_000
    assert statistics.median(ends) < 50_000
