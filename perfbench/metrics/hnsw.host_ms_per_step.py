"""hnsw.host_ms_per_step: the host's own time in one layer-0 step of the
HNSW search: the ``hnsw.step`` spans (the program's tracer) less the
``hnsw.wait`` syncs inside them, over the steps."""

from perfbench import spans


def read(run):
    return spans.host_ms(run, "hnsw.step", per="span")
