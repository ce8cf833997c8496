#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the cards of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the compared numbers as the last lines of standard error and the
result as one JSON object, the last line of standard output.  Exits
non-zero, printing no result, without CUDA, with fewer cards than the cell
asks for, or where ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# this folder's modules only as the package ``perfbench``; the program from
# the checkout's ``src``
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


if __name__ == "__main__":
    from perfbench import harness
    sys.exit(harness.cli(ROOT, sys.argv[1:], T_START))
