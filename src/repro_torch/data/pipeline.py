"""Sharded host data pipeline with background prefetch onto the device.

The counterpart of the JAX package's ``repro.data.pipeline``: every host
materialises only its own shard of the global batch (`host_slice`), and a
bounded background queue (`Prefetcher`) hides the host-to-device copy
behind the consumer's work.  `device_put_batches` copies each batch (a
numpy array, or dicts, lists and tuples of them) onto the device: on the
card through pinned host memory on a copy stream of its own, which the
consumer's stream waits on.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import resolve_device


def host_slice(global_batch: int, num_hosts: int, host_id: int) -> slice:
    """Contiguous rows of the global batch owned by `host_id`."""
    if global_batch % num_hosts != 0:
        raise ValueError(f"global_batch {global_batch} % hosts {num_hosts} != 0")
    per = global_batch // num_hosts
    return slice(host_id * per, (host_id + 1) * per)


class Prefetcher:
    """Bounded background prefetch of an iterator (depth-N double buffering)."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._transform = transform
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in it:
                    if self._transform is not None:
                        item = self._transform(item)
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class _CardBatches(Prefetcher):
    """Batches copied onto a card by the prefetch thread: each numpy leaf
    goes into pinned host memory and then, asynchronously, to the card on
    ``stream`` (not the consumer's); an event marks the batch's copies.
    ``__next__`` makes the consumer's current stream wait on that event and
    records the tensors on it, so that their memory is not reused while the
    consumer's work may still read them.  A pinned buffer may be dropped
    as soon as its copy is issued: PyTorch's caching host allocator records
    an event for each asynchronous copy out of a pinned block and does not
    hand the block out again before that event has fired."""

    def __init__(self, it: Iterator[Any], device: torch.device, depth: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        super().__init__(it, depth=depth, transform=self._put)

    def _put(self, batch):
        leaves, spec = pytree.tree_flatten(batch)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                   .to(self.device, non_blocking=True) for a in leaves]
            done = torch.cuda.Event()
            done.record(self.stream)
        return pytree.tree_unflatten(out, spec), done

    def __next__(self):
        batch, done = super().__next__()
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        for t in pytree.tree_leaves(batch):
            t.record_stream(consumer)
        return batch


def device_put_batches(it: Iterator[Any], device="cuda",
                       depth: int = 2) -> Iterator[Any]:
    """Prefetch each batch of numpy arrays (dicts, lists and tuples of them)
    onto ``device`` (the card unless the caller asks for the CPU), up to
    ``depth`` batches ahead.  On the CPU the leaves become tensors that
    share the arrays' memory."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        return _CardBatches(it, dev, depth)
    return Prefetcher(it, depth=depth, transform=lambda batch: pytree.tree_map(
        lambda a: torch.from_numpy(np.asarray(a)), batch))
