"""hnsw.fresh_slot_share: the share of the (Q, width x M0) slots B1 is
launched over at each layer-0 step that are fresh, the rows the step uses:
the ``hnsw.step`` spans' ``fresh`` count over their ``slots`` count."""

from perfbench import spans


def read(run):
    return spans.share(run, "hnsw.step", "fresh", "slots")
