"""Request batching + straggler-tolerant fan-out for serving.

The paper's Query Processing module, production-shaped:
  * `RequestBatcher` — collects single queries into fixed-size padded batches
    (deadline-bounded, so tail latency is capped even at low QPS)
  * `QuorumFanout` — sends a search to every corpus shard and merges what
    returns within the deadline; slow shards degrade recall instead of
    blocking the query (degraded-read straggler mitigation).

Carried across from the JAX package's ``repro.serving.batcher`` unchanged
but for the padding comment, which speaks of the card.  `QuorumFanout`'s
daemon threads launch their shards' kernels on the device's current stream.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    query: np.ndarray
    k: int
    future: "Future"
    enqueued_at: float
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # requests are only co-batched when their extras (filter/ef/...) agree;
    # repr-compare since extras values (Filter trees) aren't hashable
    extras_key: str = ""

    def __post_init__(self):
        # drop None-valued extras so `submit(q, k)` and
        # `submit(q, k, flt=None)` land in the same batch
        self.extras = {k: v for k, v in self.extras.items() if v is not None}
        self.extras_key = repr(sorted(self.extras.items()))


class Future:
    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def set(self, value):
        if self._ev.is_set():       # first resolution wins (close() may race
            return                  # the worker on a straggling batch)
        self._value = value
        self._ev.set()

    def set_exception(self, exc: BaseException):
        if self._ev.is_set():
            return
        self._exc = exc
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


class BatcherClosed(RuntimeError):
    """Submit after close(), or a request stranded by shutdown.  Typed so
    the service plane can map it to UNAVAILABLE without string matching."""

    def __init__(self, message: str = "batcher closed"):
        super().__init__(message)


class RequestBatcher:
    """Pads/batches requests; flushes on max_batch or max_wait_ms."""

    def __init__(self, search_fn: Callable[[np.ndarray, int], Tuple],
                 max_batch: int = 32, max_wait_ms: float = 5.0):
        self._search = search_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._carry: Optional[Request] = None   # guarded-by: _state_lock
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = True                    # guarded-by: _state_lock
        self._state_lock = threading.Lock()   # serializes submit/close/worker
        self.batches_served = 0      # guarded-by: _state_lock
        self.requests_served = 0     # guarded-by: _state_lock
        self.carried_requests = 0    # guarded-by: _state_lock
        self._thread.start()

    def submit(self, query: np.ndarray, k: int, **extras: Any) -> Future:
        """Enqueue one query.  `extras` (e.g. flt=..., params=AnnParams(...))
        are forwarded to search_fn; requests are only co-batched when their
        extras match (dataclass reprs make equal knob structs coalesce).

        Raises RuntimeError once `close()` has been called — the worker loop
        is gone, so enqueueing would leave the future to dangle until the
        caller's timeout."""
        with self._state_lock:
            if not self._running:
                raise BatcherClosed()
            fut = Future()
            self._q.put(Request(np.asarray(query, np.float32), k, fut,
                                time.perf_counter(), dict(extras)))
            return fut

    @staticmethod
    def zero_stats() -> Dict[str, int]:
        """Counter shape for collections whose batcher never started."""
        return {"batches_served": 0, "requests_served": 0,
                "carried_requests": 0, "queue_depth": 0}

    def stats(self) -> Dict[str, int]:
        """Serving observability counters (`/stats` endpoint feed)."""
        with self._state_lock:
            return {"batches_served": self.batches_served,
                    "requests_served": self.requests_served,
                    "carried_requests": self.carried_requests,
                    "queue_depth": self._q.qsize()}

    def close(self, timeout: float = 2.0):
        """Stop the worker.  Requests it never got to — queued behind the
        shutdown sentinel or carried between batches — have their futures
        failed with RuntimeError rather than silently dropped."""
        with self._state_lock:
            if not self._running:
                return                        # idempotent
            self._running = False
            self._q.put(None)
        self._thread.join(timeout=timeout)
        # If the worker is still alive (stuck in a slow search_fn), it owns
        # _carry and may be mid-pop on the queue; it sweeps both in its own
        # exit path.  Sweeping here too covers the already-dead case and is
        # idempotent (futures resolve first-wins).
        self._fail_pending(BatcherClosed())

    def _fail_pending(self, exc: BaseException) -> None:
        with self._state_lock:
            carry, self._carry = self._carry, None
        if carry is not None:
            carry.future.set_exception(exc)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.future.set_exception(exc)

    def _loop(self):
        try:
            self._serve_batches()
        finally:
            # a request popped between close()'s sweep and our exit would
            # otherwise dangle (neither batched nor failed)
            self._fail_pending(BatcherClosed())

    def _serve_batches(self):
        while True:
            with self._state_lock:
                if not self._running:
                    return
                first, self._carry = self._carry, None
            if first is None:
                first = self._q.get()
                if first is None:
                    return
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    with self._state_lock:
                        self._running = False
                    break
                if nxt.extras_key != first.extras_key:
                    with self._state_lock:  # incompatible: heads next batch
                        self._carry = nxt
                        self.carried_requests += 1
                    break
                batch.append(nxt)
            try:
                k = max(r.k for r in batch)
                queries = np.stack([r.query for r in batch])
                # pad the batch up to the next power of two (capped at
                # max_batch): every kernel launch of the search then sees
                # one of log2(max_batch) query counts, at <= 2x padded
                # compute — the shapes a CUDA-graph capture of the search
                # would have to cover, and the small-batch tile of the
                # exact scan's l2_distance kernel (Q <= 32).
                bucket = min(self.max_batch,
                             1 << (len(batch) - 1).bit_length())
                if bucket > len(batch):
                    fill = np.broadcast_to(
                        queries[:1], (bucket - len(batch),) +
                        queries.shape[1:])
                    queries = np.concatenate([queries, fill])
                d, ids = self._search(queries, k, **first.extras)
                d, ids = np.asarray(d)[: len(batch)], \
                    np.asarray(ids)[: len(batch)]
            except Exception as exc:          # surface, don't kill the loop
                for r in batch:
                    r.future.set_exception(exc)
                continue
            # count before resolving: a caller reading stats() right after
            # its result arrives must see this batch reflected
            with self._state_lock:
                self.batches_served += 1
                self.requests_served += len(batch)
            for i, r in enumerate(batch):
                r.future.set((d[i, : r.k], ids[i, : r.k]))


class QuorumFanout:
    """Fan a query out to per-shard searchers; merge whatever answers within
    the deadline (min_quorum shards required, else TimeoutError)."""

    def __init__(self, shard_search_fns: Sequence[Callable],
                 deadline_ms: float = 50.0, min_quorum: int = 1):
        self.fns = list(shard_search_fns)
        self.deadline = deadline_ms / 1e3
        self.min_quorum = min_quorum
        self.last_responders = 0

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        results: List[Optional[Tuple]] = [None] * len(self.fns)

        def run(i):
            try:
                results[i] = self.fns[i](queries, k)
            except Exception:
                results[i] = None

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(self.fns))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            left = self.deadline - (time.perf_counter() - t0)
            t.join(max(left, 0))
        got = [r for r in results if r is not None]
        self.last_responders = len(got)
        if len(got) < self.min_quorum:
            raise TimeoutError(
                f"only {len(got)}/{len(self.fns)} shards answered")
        all_d = np.concatenate([np.asarray(d) for d, _ in got], axis=1)
        all_i = np.concatenate([np.asarray(i) for _, i in got], axis=1)
        order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(all_d, order, axis=1),
                np.take_along_axis(all_i, order, axis=1))
