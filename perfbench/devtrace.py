"""What the benchmark reads from a ``torch.profiler`` trace of the window.

`summarize` takes the raw events (``kineto_results.events()``: building the
profiler's event tree over ~10^6 events takes minutes) and the window's own
annotation (``WINDOW``), leaves out the annotations the profiler copies onto
the device's timeline, and keeps:

- ``busy_s``: the union of the device's kernel, copy and set intervals that
  fall in the window (so overlapping streams count once);
- ``window_s``: the window's length;
- ``kernels``: {kernel name: [launches, seconds]} (copies and sets apart);
- ``device_ops``: the device operations that took most time, by short name;
- ``idle_gaps``: the device's idle time in the window by what the host was
  doing: the innermost host event (a torch operation or a CUDA runtime
  call) open at each gap's middle, or ``host: no torch op`` inside the
  benchmark's own batch annotation.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, Iterable, List, Tuple

#: the annotation around the traced window, and around each batch
WINDOW = "perfbench.window"
BATCH = "perfbench.batch"
TOP = 10


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void |[<(].*$", "", name)[:80] or name[:80]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def union_s(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> float:
    """Seconds of [lo, hi) ns covered by the union of the intervals."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e9


def idle_intervals(intervals: List[Tuple[int, int]], lo: int,
                   hi: int) -> List[Tuple[int, int]]:
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_gaps(gaps: List[Tuple[int, int]],
               host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of idle gap by the innermost host event open at each gap's
    middle (events nested as one thread's calls are)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out: Dict[str, float] = collections.Counter()
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            stack.append(host[i])
            i += 1
        stack = [h for h in stack if h[1] > mid]
        label = "host: outside the window's batches"
        for s, e, name in reversed(stack):
            if name == BATCH:
                label = "host: no torch op"
                break
            if name != WINDOW:
                label = name
                break
        out[label] += (b - a) / 1e9
    return out


def _annotation(e) -> bool:
    """A host annotation the profiler copies onto the device's timeline:
    no device work."""
    marked = getattr(e, "is_user_annotation", None)
    return e.name() in (WINDOW, BATCH) or bool(marked and marked())


def summarize(events, cuda_type, cpu_type) -> dict:
    """The summary of raw kineto events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``)."""
    window = None
    host: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        kind = e.device_type()
        if kind == cpu_type:
            if name == WINDOW:
                window = (start, start + dur)
            else:
                host.append((start, start + dur, name))
        elif kind == cuda_type and not _annotation(e):
            dev.append((start, start + dur, name))
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    return summarize_intervals(window, host, dev)


def summarize_intervals(window: Tuple[int, int],
                        host: List[Tuple[int, int, str]],
                        dev: List[Tuple[int, int, str]]) -> dict:
    lo, hi = window
    inside = [(a, b, n) for a, b, n in dev if b > lo and a < hi]
    spans = [(a, b) for a, b, _ in inside]
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, float] = collections.Counter()
    for a, b, n in inside:
        ops[short_name(n)] += (b - a) / 1e9
        if not is_copy(n):
            c = kernels.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) / 1e9
    gaps = label_gaps(idle_intervals(spans, lo, hi),
                      [h for h in host if h[1] > lo and h[0] < hi])
    return {"busy_s": union_s(spans, lo, hi), "window_s": (hi - lo) / 1e9,
            "kernels": kernels,
            "device_ops": [[n, s] for n, s in
                           sorted(ops.items(), key=lambda x: -x[1])[:TOP]],
            "idle_gaps": [[n, s] for n, s in
                          sorted(gaps.items(), key=lambda x: -x[1])[:TOP]]}


def kernel_totals(summary: dict, parts: Tuple[str, ...]) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose names hold any of ``parts``."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if any(p in name for p in parts):
            n += count
            s += secs
    return n, s
