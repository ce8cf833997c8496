"""ivf.host_ms_per_batch: the host's own time in the IVF search a batch:
the ``ivf.search`` spans (the program's tracer; the probe, the lists' scan
and merge, the ids) less any wait inside them, over the window's batches."""

from perfbench import spans


def read(run):
    return spans.host_ms(run, "ivf.search")
