#!/usr/bin/env python3
"""Recall of a collection, JAX package or PyTorch port, on the CPU.

Builds an HNSW collection with the bulk builder (``--quantization`` none,
pq: m=16 k=256, or bq: 256 bits, the settings of ``chip_smoke.py``'s phases
C and D), or with ``--index ivf`` an IVF collection (``--nlist``, each
``--nprobe`` in turn; phase G is nlist 1,024, nprobe 32 at 1M), with one
package and prints recall@10 and wall seconds at each ef or nprobe,
against an exact top-k, over the corpus and queries of one of
``chip_smoke.py``'s phases at a smaller n; quantized collections also
report the first pass alone (no exact rescore) at the first ef:

  sift    phase A: cosine over ``sift_like(n, seed=0)``, the first
          ``--queries`` rows of ``sift_like(10_000, seed=1)``;
  fmnist  phase B: l2 over ``fashion_mnist_like(n, seed=0)``, the first
          ``--queries`` rows of ``fashion_mnist_like(1_000, seed=1)``.

It imports only the package that ``--package`` names, so the two can be held
to each other on the same data:

    PYTHONPATH=src python3 scripts/recall_witness.py --package jax --n 200000
    PYTHONPATH=src python3 scripts/recall_witness.py --package torch --n 200000
    PYTHONPATH=src python3 scripts/recall_witness.py --package jax \
        --quantization pq --n 20000
    PYTHONPATH=src python3 scripts/recall_witness.py --package torch \
        --index ivf --n 100000 --nlist 316 --nprobe 5 10 20

Each run prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

K = 10
WIDTH = 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--corpus", choices=("sift", "fmnist"), default="sift")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--ef", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--quantization", choices=("none", "pq", "bq"),
                    default="none")
    ap.add_argument("--index", choices=("hnsw", "ivf"), default="hnsw")
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, nargs="+", default=[32])
    args = ap.parse_args()

    if args.package == "jax":
        from repro.core import recall_at_k
        from repro.core.bq import BQConfig
        from repro.core.engine import EngineConfig, QuantixarEngine
        from repro.core.ivf import IVFConfig
        from repro.core.pq import PQConfig
        from repro.data import synthetic
        kw = {}
    else:
        from repro_torch.core import (BQConfig, EngineConfig, IVFConfig,
                                      PQConfig, QuantixarEngine, recall_at_k)
        from repro_torch.data import synthetic
        kw = {"device": "cpu"}

    if args.corpus == "sift":
        metric = "cosine"
        x = synthetic.sift_like(args.n, seed=0)
        q = synthetic.sift_like(10_000, seed=1)[: args.queries]
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = -(qn @ xn.T)
    else:
        metric = "l2"
        x = synthetic.fashion_mnist_like(args.n, seed=0)
        q = synthetic.fashion_mnist_like(1_000, seed=1)[: args.queries]
        d = (q * q).sum(1)[:, None] + (x * x).sum(1)[None] - 2.0 * (q @ x.T)
    gt = np.argsort(d, axis=1, kind="stable")[:, :K]

    eng = QuantixarEngine(EngineConfig(
        dim=x.shape[1], metric=metric, index=args.index,
        quantization=args.quantization, pq=PQConfig(m=16, k=256),
        bq=BQConfig(bits=256), builder="bulk",
        ivf=IVFConfig(nlist=args.nlist, nprobe=args.nprobe[0])), **kw)
    eng.add(x)
    t0 = time.perf_counter()
    eng.build()
    res = {"package": args.package, "corpus": args.corpus, "n": args.n,
           "queries": args.queries, "quantization": args.quantization,
           "build_s": time.perf_counter() - t0,
           "build": {k: v for k, v in eng.stats().items()
                     if k.startswith(("build", "ivf")) or k == "mean_deg0"}}
    if args.index == "ivf":
        for nprobe in args.nprobe:
            # the probe count is read at search time: one build serves all
            eng._ivf.config = dataclasses.replace(eng._ivf.config,
                                                  nprobe=nprobe)
            t0 = time.perf_counter()
            _, ids = eng.search(q, K)
            res[f"nprobe{nprobe}"] = {"recall_at_10": recall_at_k(ids, gt),
                                      "search_s": time.perf_counter() - t0}
        print(json.dumps(res, default=float), flush=True)
        return
    for ef in args.ef:
        t0 = time.perf_counter()
        _, ids = eng.search(q, K, ef=ef, expansion_width=WIDTH)
        res[f"ef{ef}"] = {"recall_at_10": recall_at_k(ids, gt),
                          "search_s": time.perf_counter() - t0}
    if args.quantization != "none":
        _, ids = eng.search(q, K, ef=args.ef[0], expansion_width=WIDTH,
                            rescore=False)
        res[f"ef{args.ef[0]}_first_pass"] = recall_at_k(ids, gt)
    print(json.dumps(res, default=float), flush=True)


if __name__ == "__main__":
    main()
