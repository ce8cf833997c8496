"""ivf_search_roofline: the least time of the IVF search the batches ask
for (``roofline.ivf_search_s``: Q x nprobe x N / nlist products of width D
at 3xTF32, every row read once) over the device's busy time in the traced
window, whatever kernels do the work."""

from perfbench import roofline


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    cfg = run.config
    ivf = cfg["engine"]["ivf"]
    least = run.batches * roofline.ivf_search_s(
        run.mix.batch, run.n_total, int(cfg["dim"]), ivf["nlist"],
        ivf["nprobe"], run.mix.k)
    return 100.0 * least / run.trace["busy_s"]
