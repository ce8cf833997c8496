"""beam_gather.ms_per_batch: the device time of B1, the HNSW layer-0
gather-distance kernel (``beam_gather_f32_kernel``), in the traced window
over its batches.  A time, not a share of a roofline: B1 runs over every
query's whole (Q, expansion width x M0) block at each step, and the work a
batch needs (the fresh slots of the queries still searching) is counted
nowhere the benchmark can read."""

from perfbench import devtrace

KERNEL = ("beam_gather_f32_kernel",)


def read(run):
    if run.trace is None:
        return None
    n, secs = devtrace.kernel_totals(run.trace, KERNEL)
    return 1e3 * secs / run.batches if n else None
