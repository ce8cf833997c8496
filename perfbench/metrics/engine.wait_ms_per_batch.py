"""engine.wait_ms_per_batch: the time the host blocked on the card a batch:
every wait span of the program's tracer (the engine's copies to the host,
the HNSW loop's syncs), over the window's batches."""

from perfbench import spans


def read(run):
    s = spans.summary(run)
    if s is None or "engine.search" not in s["spans"]:
        return None
    return 1e3 * s["wait_s"] / run.batches
