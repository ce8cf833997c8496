"""engine.host_ms_per_batch: the host's own time in ``QuantixarEngine.search``
a batch: the ``engine.search`` spans (the program's tracer) less the wait
spans inside them (the host blocked on reads of device values), over the
window's batches."""

from perfbench import spans


def read(run):
    return spans.host_ms(run, "engine.search")
