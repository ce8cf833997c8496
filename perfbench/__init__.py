"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of Quantixar.

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 perfbench/run.py --workload sift1m-ivf.batch1k --seed 7 \\
        --seconds 10 --trace 0

The harness is driven by data.  A cell names a configuration and a traffic
mix; the harness finds each by its name:

- ``configs/<config>.json``: the deployment (corpus, index, search settings,
  the guarantees and the limits of the comparison), naming the system driver
  (``systems/<system>.py``) and the plain reference (``reference/<name>.py``);
- ``workloads/<traffic>.json``: the traffic mix, read by ``traffic.py``;
- ``metrics/<metric>.py``: one reader per metric, end-to-end or per layer.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference
imports nothing of ``repro_torch`` either.
"""
