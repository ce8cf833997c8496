"""setup_s: seconds from the run's start (before torch is imported) until
the window opens: the inputs made, the program's index built, its kernels
built where a checkout has none yet, and the warm-up batches run."""


def read(run):
    return run.setup_s
