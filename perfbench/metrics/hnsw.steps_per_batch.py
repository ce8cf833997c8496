"""hnsw.steps_per_batch: launches of B1 (``beam_gather``, its wrapper's
``launches`` counter) over the window's batches: one a layer-0 step of the
wide-beam search, and one for the entry points of each search."""


def read(run):
    n = run.counters.get("beam_gather.launches", 0)
    return n / run.batches if n else None
