"""Spans of the port's search path, recorded while a torch profiler runs.

A span is one phase of one call: its name, its start and end, the span it
ran inside (its parent), the request id it shares with every span of the
same top-level call, integer counts, and whether it is a wait.  A wait
encloses a host read of a device value (``bool()``, ``int()``, ``.item()``,
``.tolist()``, ``.cpu()``): the time the host blocked on the card.  A span
opened on an empty stack is a root and starts a request.

There is one switch: spans are recorded only while a torch profiler runs
(``torch.autograd._profiler_enabled()``).  With the profiler off, `span`
returns one shared no-op context: it launches no kernel, reads nothing from
the device and records nothing.  While recording, each span also opens a
profiler range of its own name (its twin), so it appears in the profiler's
trace on the device trace's clock, and the host's time there is named by
program phase.

Each thread keeps its own stack of open spans (the batcher searches from a
worker thread), as torch's profiler records only the thread that starts it.
Closed spans go to one bounded buffer: past `MAX_SPANS` they are dropped
and counted.  A recording starts at a thread's first span recorded after a
span site of that thread found the profiler off: the buffer then starts
empty, so it holds one profiled window's spans.  `spans()` reads the
buffer, `summary()` sums it by name, `clear()` empties it.

Usage::

    with tracing.span("ivf.search", queries=nq) as sp:
        ...
        with tracing.span("engine.to_host", wait=True, bytes=n):
            out = d.cpu()
        sp.count(lists=nq * nprobe)
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple

import torch

#: closed spans the buffer holds; later ones are dropped and counted
MAX_SPANS = 1 << 18

_enabled = torch.autograd._profiler_enabled
# the twin: a profiler range without record_function's op dispatch
# (~1.4 us against ~13 us a range on a CPU); torch builds without it take
# record_function
_twin = getattr(torch._C._profiler, "_RecordFunctionFast",
                torch.profiler.record_function)


class Span(NamedTuple):
    """One closed span.  ``start_ns`` / ``end_ns`` are on the profiler's
    clock (epoch ns, as kineto stamps host events)."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent: int          # the enclosing span's id; 0 for a root
    request: int
    wait: bool
    counts: Dict[str, int]
    thread: int


class _Off:
    """The shared no-op span of a site that finds the profiler off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Buffer:
    def __init__(self):
        self.lock = threading.Lock()
        self.items: List[tuple] = []
        self.dropped = 0
        # time.time_ns() - time.perf_counter_ns(), taken as the empty
        # buffer gets its first span: spans are stamped on perf_counter,
        # kineto on the epoch
        self.offset_ns = 0


_buf = _Buffer()
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class _Live:
    __slots__ = ("name", "wait", "counts", "span_id", "parent", "request",
                 "stack", "twin", "start")

    def __init__(self, name: str, wait: bool, counts: Dict[str, int]):
        self.name = name
        self.wait = wait
        self.counts = counts

    def __bool__(self):
        return True

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            top = stack[-1]
            self.parent, self.request = top.span_id, top.request
        else:
            self.parent, self.request = 0, next(_request_ids)
        self.span_id = next(_span_ids)
        stack.append(self)
        self.stack = stack
        self.twin = _twin(self.name)
        self.twin.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.twin.__exit__(*exc)
        self.stack.pop()
        rec = (self.name, self.start, end, self.span_id, self.parent,
               self.request, self.wait, self.counts, threading.get_ident())
        # a span site of this thread found the profiler off since its last
        # span recorded: a new recording
        restart = getattr(_local, "off_seen", False)
        _local.off_seen = False
        with _buf.lock:
            if restart:
                _buf.items = []
                _buf.dropped = 0
            if not _buf.items:
                _buf.offset_ns = time.time_ns() - time.perf_counter_ns()
            if len(_buf.items) < MAX_SPANS:
                _buf.items.append(rec)
            else:
                _buf.dropped += 1
        return False

    def count(self, **counts) -> None:
        """Add to the span's integer counts."""
        for key, n in counts.items():
            self.counts[key] = self.counts.get(key, 0) + int(n)


def span(name: str, wait: bool = False, **counts):
    """A context manager for one span named ``name`` (``wait``: it encloses
    a host read of a device value), starting with ``counts``; its
    ``count(**more)`` adds to them.  The shared no-op (false in a boolean
    test) while no profiler runs."""
    if not _enabled():
        _local.off_seen = True
        return _OFF
    return _Live(name, wait, counts)


def spans() -> List[Span]:
    """The buffer's spans, in the order they closed."""
    with _buf.lock:
        items, off = list(_buf.items), _buf.offset_ns
    return [Span(n, a + off, b + off, *rest) for n, a, b, *rest in items]


def clear() -> None:
    """Empty the buffer."""
    with _buf.lock:
        _buf.items = []
        _buf.dropped = 0


def summary() -> dict:
    """The buffer summed by span name:

    - ``spans``: {name: {"n": spans, "s": seconds, "wait_s": seconds of the
      wait spans at or below them, "counts": {key: sum}}};
    - ``wait_s``: seconds of every wait span (a wait inside a wait counts
      once, as the outer one);
    - ``recorded``, ``dropped``: spans kept and dropped.
    """
    with _buf.lock:
        items, drop = list(_buf.items), _buf.dropped
    by_id = {rec[3]: rec for rec in items}
    out: Dict[str, dict] = {}
    for name, a, b, _, _, _, _, counts, _ in items:
        agg = out.get(name)
        if agg is None:
            agg = out[name] = {"n": 0, "s": 0.0, "wait_s": 0.0, "counts": {}}
        agg["n"] += 1
        agg["s"] += (b - a) / 1e9
        c = agg["counts"]
        for key, n in counts.items():
            c[key] = c.get(key, 0) + n
    total_wait = 0.0
    for name, a, b, _, parent, _, wait, _, _ in items:
        if not wait:
            continue
        names = {name}
        outer = True
        while parent in by_id:
            up = by_id[parent]
            if up[6]:
                outer = False
                break
            names.add(up[0])
            parent = up[4]
        if not outer:
            continue
        secs = (b - a) / 1e9
        total_wait += secs
        for n in names:
            out[n]["wait_s"] += secs
    return {"spans": out, "wait_s": total_wait, "recorded": len(items),
            "dropped": drop}
