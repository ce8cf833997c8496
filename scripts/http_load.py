#!/usr/bin/env python3
"""Single-vector queries against a running Quantixar HTTP server, each
query alone, from ``--threads`` threads of this process.

The server (``repro_torch.serving.http.QuantixarHTTPServer`` or the JAX
package's, whose wire format is the same) runs in another process, so the
latencies are the server's plus this client's: the server's interpreter is
not shared with the threads that send.  Reads the queries from a ``.npy``
file of shape (n, dim) and writes one JSON object to ``--out``:

  ``seconds``  wall time of the whole run;
  ``lat_s``    each query's seconds, request sent to response parsed;
  ``hits``     each query's hits as ``[id, score, payload]`` lists;
  ``errors``   the ``repr`` of every failed request (none on success).

    PYTHONPATH=src python3 scripts/http_load.py --url http://127.0.0.1:6333 \
        --collection corpus --queries q.npy --k 10 --threads 32 --out o.json

It exits non-zero if any request failed.  ``singles`` is the loop alone,
for a collection, embedded or remote, in the caller's process.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np


def singles(col, queries, k, threads):
    """Each query alone through ``col.query(v).top_k(k).run()`` (an
    embedded or a remote collection) from ``threads`` threads, query i on
    thread i % threads; returns (hit lists, per-query seconds, errors),
    a failed query's hits empty and its seconds 0."""
    n = len(queries)
    lat = [0.0] * n
    hits = [[] for _ in range(n)]
    errors = []

    def worker(tid):
        for i in range(tid, n, threads):
            t0 = time.perf_counter()
            try:
                got = col.query(queries[i]).top_k(k).run()
            except Exception as e:          # reported to the caller
                errors.append(repr(e))
                continue
            lat[i] = time.perf_counter() - t0
            hits[i] = got

    workers = [threading.Thread(target=worker, args=(t,))
               for t in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    return hits, lat, errors


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", required=True)
    ap.add_argument("--collection", required=True)
    ap.add_argument("--queries", required=True, help=".npy, (n, dim)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--threads", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from repro_torch.api.client import QuantixarClient

    queries = np.load(args.queries)
    remote = QuantixarClient(args.url, timeout=args.timeout) \
        .collection(args.collection)
    t0 = time.perf_counter()
    hits, lat, errors = singles(remote, queries, args.k, args.threads)
    seconds = time.perf_counter() - t0
    hits = [[[h.id, h.score, h.payload] for h in row] for row in hits]
    with open(args.out, "w") as f:
        json.dump({"seconds": seconds, "lat_s": lat, "hits": hits,
                   "errors": errors}, f)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
