"""hnsw.active_query_share: the share of the batch's queries still
searching at each layer-0 step, while the lockstep batch runs to its
slowest query: the ``hnsw.step`` spans' ``active`` count over their
``queries`` count."""

from perfbench import spans


def read(run):
    return spans.share(run, "hnsw.step", "active", "queries")
