"""The trace reader on a synthetic event list."""

import pytest

from perfbench import devtrace

CPU, CUDA = "cpu", "cuda"


class Ev:
    def __init__(self, name, kind, start, dur, annotation=False):
        self._n, self._k, self._s, self._d = name, kind, start, dur
        self._a = annotation

    def is_user_annotation(self):
        return self._a

    def name(self):
        return self._n

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def events():
    return [
        Ev(devtrace.WINDOW, CPU, 1000, 10_000),          # [1000, 11000)
        Ev(devtrace.BATCH, CPU, 1000, 9_000),
        Ev("aten::topk", CPU, 1500, 2_000),              # [1500, 3500)
        Ev("cudaStreamSynchronize", CPU, 6000, 1_000),   # [6000, 7000)
        Ev("void beam_gather_f32_kernel<4>(float*)", CUDA, 500, 1_000),
        Ev("void beam_gather_f32_kernel<4>(float*)", CUDA, 2000, 1_000),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 2500, 1_000),
        Ev("ncclDevKernel_AllGather_RING_LL(x)", CUDA, 8000, 500),
        Ev("nccl:all_gather", CUDA, 8000, 500, annotation=True),
        Ev(devtrace.WINDOW, CUDA, 1000, 10_000),         # the device copy
    ]


def test_union_launches_and_gaps():
    s = devtrace.summarize(events(), CUDA, CPU)
    # device busy: [1000, 1500) + [2000, 3500) + [8000, 8500)
    assert s["busy_s"] == pytest.approx(2_500e-9)
    assert s["window_s"] == pytest.approx(10_000e-9)
    assert s["kernels"] == {
        "void beam_gather_f32_kernel<4>(float*)": [2, 2_000e-9],
        "ncclDevKernel_AllGather_RING_LL(x)": [1, 500e-9]}
    assert devtrace.kernel_totals(s, ("beam_gather_f32",)) == \
        (2, pytest.approx(2_000e-9))
    gaps = dict(s["idle_gaps"])
    # [1500, 2000): in aten::topk; [3500, 8000): mid 5750, the batch only;
    # [8500, 11000): mid 9750, the batch only
    assert gaps["aten::topk"] == pytest.approx(500e-9)
    assert gaps["host: no torch op"] == pytest.approx(7_000e-9)
    assert sum(gaps.values()) == pytest.approx(
        s["window_s"] - s["busy_s"])
    assert s["device_ops"][0] == ["beam_gather_f32_kernel",
                                  pytest.approx(2_000e-9)]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.summarize(events()[1:-1], CUDA, CPU)
