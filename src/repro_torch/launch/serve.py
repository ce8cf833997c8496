"""Serving driver: run Quantixar as a real server, or demo/smoke the stack.

Modes:
  * default — embedded demo: build a collection, push requests through the
    serving batcher, report QPS/recall (the pre-service-plane behaviour).
  * `--serve` — start the embedded HTTP server (`repro_torch.serving.http`)
    on --host/--port and serve until interrupted:

        PYTHONPATH=src python -m repro_torch.launch.serve --serve --port 6333 \
            --n 20000 --dim 128 --index hnsw --quant pq

  * `--smoke` — CI smoke: start a server on an ephemeral port, drive it with
    concurrent `QuantixarClient` searches, assert recall, batcher
    coalescing, query-plan parity (coarse-to-fine `.stages()` + `.explain()`
    plan echo, prefetch+RRF fusion, filtered `count`) between embedded and
    wire, and a clean shutdown; exit non-zero on any failure.

Carried across from the JAX package's ``repro.launch.serve`` with the same
options, plus ``--device`` (default ``cuda``): the torch device the database
runs on (``--device cpu`` on a host without a card).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

from ..api import (BatcherConfig, Database, KeywordField, QuantixarClient,
                   VectorField)
from ..core.hnsw_build import HNSWConfig, exact_knn
from ..data.synthetic import gaussian_mixture


def build_database(n: int, dim: int, index: str, quant: str,
                   seed: int = 0, max_batch: int = 32,
                   max_wait_ms: float = 2.0, expansion_width: int = 4,
                   shards: int = 1, device="cuda"):
    """Returns (db, corpus) so callers score recall against exactly the
    vectors that were indexed.  `shards > 1` builds a `ShardedCollection`
    (hash-partitioned scatter-gather) instead of a single engine."""
    db = Database(device=device)
    col = db.create_collection(
        name="corpus",
        vector=VectorField(dim=dim, index=index, quantization=quant,
                           builder="bulk",
                           hnsw=HNSWConfig(expansion_width=expansion_width)),
        fields=(KeywordField("shard"),),
        batcher=BatcherConfig(max_batch=max_batch, max_wait_ms=max_wait_ms),
        shards=shards)
    corpus = gaussian_mixture(n, dim, seed=seed)
    ids = [f"vec-{i}" for i in range(n)]
    payloads = [{"shard": f"s{i % 8}"} for i in range(n)]
    col.upsert(ids, corpus, payloads)
    return db, corpus


def _recall_of(results, gt, k) -> float:
    hits = sum(len({h.id for h in r} & {f"vec-{j}" for j in t})
               for r, t in zip(results, gt))
    return hits / (len(results) * k)


def run_embedded_demo(args) -> int:
    print(f"[serve] building {args.index}+{args.quant} over {args.n} vectors")
    t0 = time.perf_counter()
    db, corpus = build_database(args.n, args.dim, args.index, args.quant,
                                max_batch=args.max_batch,
                                expansion_width=args.width,
                                device=args.device)
    col = db["corpus"]
    col.query(gaussian_mixture(1, args.dim, seed=7)[0]).top_k(1).run()
    print(f"[serve] built in {time.perf_counter() - t0:.1f}s; "
          f"stats={col.stats()}")

    # the Collection's query path IS the batcher path: concurrent submits
    # coalesce into padded engine batches
    queries = gaussian_mixture(args.requests, args.dim, seed=99)
    t0 = time.perf_counter()
    futures = [col.batcher.submit(q, args.k) for q in queries]
    results = [f.result(timeout=60) for f in futures]
    dt = time.perf_counter() - t0

    gt = exact_knn(queries, corpus, args.k, metric="cosine")
    hits = sum(len(set(rows.tolist()) & set(t.tolist()))
               for (_, rows), t in zip(results, gt))
    recall = hits / (len(queries) * args.k)
    print(f"[serve] {args.requests} requests in {dt:.2f}s "
          f"({args.requests / dt:.0f} QPS host-side), "
          f"{col.batcher.batches_served} batches, "
          f"recall@{args.k}={recall:.3f}")

    hits = (col.query(queries[0]).filter(shard="s3").top_k(5).run())
    print(f"[serve] filtered query shard==s3 -> "
          f"{[(h.id, h.payload['shard']) for h in hits]}")
    db.close()
    return 0


def _start_server(args, port: int):
    from ..serving.http import QuantixarHTTPServer
    from ..serving.service import QuantixarService, ServiceConfig

    db, corpus = build_database(args.n, args.dim, args.index, args.quant,
                                max_batch=args.max_batch,
                                expansion_width=args.width,
                                device=args.device)
    # warm the index so the first client query doesn't pay the build
    db["corpus"].query(gaussian_mixture(1, args.dim, seed=7)[0]).top_k(1).run()
    service = QuantixarService(
        db, ServiceConfig(default_max_batch=args.max_batch))
    server = QuantixarHTTPServer(service, host=args.host, port=port,
                                 verbose=args.verbose)
    return server, corpus


def run_server(args) -> int:
    import signal

    print(f"[serve] building {args.index}+{args.quant} over {args.n} vectors")
    server, _ = _start_server(args, args.port)
    print(f"[serve] listening on {server.url}")
    print(f"[serve] try: curl {server.url}/v1/collections/corpus/stats")
    # SIGTERM (k8s / systemd stop) drains like Ctrl-C
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\n[serve] shutting down")
        server.shutdown()
    return 0


def _plan_smoke(server, col, queries, args):
    """Embedded-vs-remote parity of the declarative plan surface: the same
    coarse-to-fine / fused / count queries against the served Database and
    the wire client must agree hit for hit, and `explain()` must echo the
    compiled plan with per-stage counts and timings on both sides."""
    failures = []
    embedded = server.service.db["corpus"]
    k = args.k

    wire_ex = col.query(queries[0]).top_k(k).stages(oversample=4).explain()
    emb_ex = embedded.query(queries[0]).top_k(k).stages(oversample=4) \
        .explain()
    if [h.id for h in wire_ex.hits] != [h.id for h in emb_ex.hits]:
        failures.append("coarse-to-fine wire hits != embedded hits")
    if wire_ex.plan != emb_ex.plan:
        failures.append("explain() plan echo differs embedded vs wire")
    for name, ex in (("wire", wire_ex), ("embedded", emb_ex)):
        shape = [s["stage"] for s in ex.stages]
        if shape != ["ann", "rescore"]:
            failures.append(f"{name} explain stages {shape} != ann+rescore")
        elif not all(s["candidates_out"] > 0 and s["seconds"] >= 0
                     for s in ex.stages):
            failures.append(f"{name} explain missing counts/timings")

    fused, fused_emb = [], []
    for backend, out in ((col, fused), (embedded, fused_emb)):
        q = backend.query(queries[1]).top_k(k)
        for s in range(4):
            q = q.prefetch(shard=f"s{s}")
        out.extend(q.fuse("rrf").run())
    if [h.id for h in fused] != [h.id for h in fused_emb]:
        failures.append("prefetch+RRF wire hits != embedded hits")
    if len(fused) != k:
        failures.append(f"fused query returned {len(fused)}/{k} hits")

    wire_n, embedded_n = col.count(), embedded.count()
    if wire_n != args.n or wire_n != embedded_n:
        failures.append(f"count() mismatch: wire {wire_n} "
                        f"embedded {embedded_n} n {args.n}")
    print(f"[smoke] plan parity: explain={[s['stage'] for s in wire_ex.stages]}"
          f" fused_k={len(fused)} count={wire_n} "
          f"({'ok' if not failures else 'FAILED'})")
    return failures


def run_smoke(args) -> int:
    """Start server → N concurrent client queries → assert recall +
    coalescing + clean shutdown.  The CI serve-smoke job."""
    failures = []
    print(f"[smoke] building {args.index}+{args.quant} over {args.n} vectors")
    server, corpus = _start_server(args, port=0)
    server.start()
    client = QuantixarClient(server.url, timeout=60)
    col = client.collection("corpus")

    queries = gaussian_mixture(args.requests, args.dim, seed=99)
    gt = exact_knn(queries, corpus, args.k, metric="cosine")
    results = [None] * len(queries)

    def worker(i):
        results[i] = col.query(queries[i]).top_k(args.k).run()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    dt = time.perf_counter() - t0

    if any(r is None for r in results):
        failures.append("some client queries never completed")
    else:
        recall = _recall_of(results, gt, args.k)
        stats = col.stats()
        batches = stats["serving_batches_served"]
        served = stats["serving_requests_served"]
        print(f"[smoke] {len(queries)} wire queries in {dt:.2f}s "
              f"({len(queries) / dt:.0f} QPS), recall@{args.k}={recall:.3f}, "
              f"{batches} batches for {served} batched requests")
        if recall < args.min_recall:
            failures.append(f"recall {recall:.3f} < {args.min_recall}")
        if served < len(queries):
            failures.append(f"only {served} requests took the batcher path")
        if batches >= served and served > 1:
            failures.append(
                f"no coalescing: {batches} batches for {served} requests")

    failures += _plan_smoke(server, col, queries, args)

    try:
        server.shutdown()
    except Exception as exc:                  # noqa: BLE001
        failures.append(f"shutdown failed: {exc}")
    for f in failures:
        print(f"[smoke] FAIL: {f}")
    print(f"[smoke] {'FAILED' if failures else 'PASSED'}")
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--index", default="hnsw", choices=["hnsw", "flat", "ivf"])
    ap.add_argument("--quant", default="none", choices=["none", "pq", "bq"])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--width", type=int, default=4,
                    help="wide-beam expansion width (HNSW serving default)")
    ap.add_argument("--serve", action="store_true",
                    help="run the HTTP server until interrupted")
    ap.add_argument("--smoke", action="store_true",
                    help="server + concurrent client queries + assertions")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6333)
    ap.add_argument("--min-recall", type=float, default=0.7)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the database (cpu on a host "
                         "without a card)")
    ap.add_argument("--verbose", action="store_true",
                    help="per-request HTTP logging")
    args = ap.parse_args()

    if args.smoke:
        return run_smoke(args)
    if args.serve:
        return run_server(args)
    return run_embedded_demo(args)


if __name__ == "__main__":
    sys.exit(main())
