"""hnsw.step_launches_per_batch: launches of B1ˢ (``beam_gather_step``,
its wrapper's ``step_launches`` counter), the HNSW layer-0 step in one
kernel, over the window's batches: one a layer-0 step of the float-mode
search.  No reading from a program without that counter."""


def read(run):
    n = run.counters.get("beam_gather.step_launches", 0)
    return n / run.batches if n else None
