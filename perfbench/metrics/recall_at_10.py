"""recall_at_10: the share of the reference's exact top-k found, over every
query answered in the window."""


def read(run):
    return run.hits / (run.compared * run.mix.k)
