"""qps: every query answered in the window over the window's seconds, from
the first batch's call to the last batch's ids on the host."""


def read(run):
    return run.queries / run.window_s
