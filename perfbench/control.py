#!/usr/bin/env python3
"""The control of a cell: the plain reference in the program's place at the
precision below the configuration's (``systems/control.py``: TF32
products), driven through the rest of a run and judged by the same
comparison.  It has to come out as not correct; its numbers are the upper
readings the limits are set below.  The benchmark's own runs never run it.

    python3 perfbench/control.py --workload <name> --seed <n> --seconds <s>
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
    sys.exit(harness.cli(ROOT, sys.argv[1:], T_START, system="control"))
