#!/usr/bin/env python3
"""The distributed search across the cards of one host, one process a card.

Run from the repository root on a host with 4 cards:

    python3 scripts/distributed_cards.py                 # world 4, NCCL
    python3 scripts/distributed_cards.py --device cpu --n 20000   # gloo

It starts ``--world`` processes (rank r on card r), joined by NCCL (gloo
with ``--device cpu``) at tcp://localhost on a free port.  Every rank makes
phase A's corpus and queries of ``chip_smoke.py`` (``sift_like``, seeds 0
and 1, ``--n`` rows; flat cosine as -q.x on unit rows, flat l2), and PQ
(m 16, k 256) and BQ (256 bits) codes from quantizers rank 0 trains
(seed 0) and broadcasts.  For each mesh, (world, 1) and (world / 2, 2),
and each layout ("rows", "dims"), each scan runs ``--batches`` batches of
1,024 queries at k = 100 (``configs/quantixar_db.py``), every rank with its
own block (``local_block``), and prints from rank 0 one JSON line: QPS over
the batches (host clock from a barrier before the first to a synchronise
and barrier after the last), the collective bytes a batch (all_gather of the candidates; in
"dims" the all_reduce of the partial distances), and whether the first
batch's answer equals ``emulate_search`` (one process playing the same
ranks through the same per-rank functions, on the rank's own card) bit for
bit and is the same on every rank.  Any disagreement exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

QUERY_BATCH, TIMEOUT_S = 1024, 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank(rank: int, args) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.quantixar_db import CONFIG as DB
    from repro_torch.core import (BinaryQuantizer, BQConfig, PQConfig,
                                  ProductQuantizer, normalize)
    from repro_torch.data.synthetic import sift_like
    from repro_torch.distributed import search as ds
    from repro_torch.launch.mesh import mesh_axis_sizes

    on_card = args.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    dev = torch.device(f"cuda:{rank}" if on_card else "cpu")
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=rank,
        world_size=args.world, device_id=dev if on_card else None,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))

    def sync():
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()

    x_raw = torch.as_tensor(sift_like(args.n, seed=0), device=dev)
    q_raw = torch.as_tensor(
        sift_like(args.batches * QUERY_BATCH, seed=1), device=dev)
    pq = ProductQuantizer(PQConfig(m=DB.pq_m, k=DB.pq_k, metric=DB.metric),
                          device=dev)
    bq = BinaryQuantizer(BQConfig(bits=DB.bq_bits), device=dev)
    if rank == 0:
        pq.train(x_raw, seed=0)
        bq.train(x_raw, seed=0)
    else:
        pq.codebooks = torch.empty((DB.pq_m, DB.pq_k, 128 // DB.pq_m),
                                   device=dev)
        bq.hyperplanes = torch.empty((DB.bq_bits, 128), device=dev)
        bq.mean = torch.empty((128,), device=dev)
    for t in (pq.codebooks, bq.hyperplanes, bq.mean):
        dist.broadcast(t, src=0)
    w = bq.config.words
    # scan -> (kind, scan metric, corpus / codes, queries -> their side,
    # feature width, maker)
    scans = {
        "flat_cosine": ("flat", "dot", normalize(x_raw), normalize, 128,
                        lambda mesh, mode: ds.make_flat_search(
                            mesh, k=DB.k, metric="cosine", dim=128,
                            mode=mode)),
        "flat_l2": ("flat", "l2", x_raw, lambda q: q, 128,
                    lambda mesh, mode: ds.make_flat_search(
                        mesh, k=DB.k, metric="l2", dim=128, mode=mode)),
        "pq": ("pq", "adc", pq.encode(x_raw), pq.lut, DB.pq_m,
               lambda mesh, mode: ds.make_pq_search(
                   mesh, k=DB.k, m_subspaces=DB.pq_m, mode=mode)),
        "bq": ("hamming", "hamming", bq.encode(x_raw), bq.encode, w,
               lambda mesh, mode: ds.make_hamming_search(
                   mesh, k=DB.k, words=w, mode=mode))}
    batches = [q_raw[lo: lo + QUERY_BATCH]
               for lo in range(0, len(q_raw), QUERY_BATCH)]
    failed = False
    for shape in ((args.world, 1), (args.world // 2, 2)):
        mesh = init_device_mesh(dev.type, shape,
                                mesh_dim_names=("data", "model"))
        sizes = mesh_axis_sizes(mesh)
        for mode in ("rows", "dims"):
            for name, (kind, metric, x, side, width, make) in scans.items():
                fn = make(mesh, mode)
                lay = ds.layout(sizes, mode, width)
                block = ds.local_block(x, mesh, mode, dim=width)
                sides = [side(b) for b in batches]
                qs = [ds.local_block(s, mesh, mode, rows=False, dim=width)
                      for s in sides]
                got = fn(block, qs[0])                    # warm-up
                sync()
                t0 = time.perf_counter()
                for q in qs:
                    fn(block, q)
                sync()
                secs = time.perf_counter() - t0
                want = ds.emulate_search(kind, metric, x, sides[0], DB.k,
                                         sizes, mode, width)
                same = (torch.equal(got[1], want[1])
                        and torch.equal(got[0].view(torch.int32),
                                        want[0].view(torch.int32)))
                # every rank's answer against rank 0's
                ref = [t.clone() for t in got]
                for t in ref:
                    dist.broadcast(t, src=0)
                everywhere = torch.tensor(
                    [int(all(torch.equal(a, b) for a, b in zip(got, ref))
                         and same)], device=dev)
                dist.all_reduce(everywhere, op=dist.ReduceOp.MIN)
                ok = bool(everywhere.item())
                failed |= not ok
                n_local = x.shape[0] // lay.shards
                kk = min(DB.k, n_local)
                gather_b = QUERY_BATCH * kk * 8 * lay.shards
                reduce_b = (QUERY_BATCH * n_local * 4 if lay.split else 0)
                if rank == 0:
                    print(json.dumps({
                        "mesh": sizes, "mode": mode, "scan": name,
                        "rows_per_rank": n_local,
                        "width_per_rank": width // lay.models,
                        "qps": len(qs) * QUERY_BATCH / secs,
                        "batch_ms": secs / len(qs) * 1e3,
                        "gather_bytes_per_batch": gather_b,
                        "reduce_bytes_per_batch": reduce_b,
                        "equals_emulation_on_every_rank": ok}), flush=True)
    dist.destroy_process_group()
    if failed:
        raise SystemExit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.world % 2 or args.world < 2:
        print("distributed_cards: --world must be even", file=sys.stderr)
        return 2
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"distributed_cards: {torch.cuda.device_count()} cards for "
              f"--world {args.world}", file=sys.stderr)
        return 2
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build()               # once, before the ranks load it
    args.port = free_port()
    ctx = mp.start_processes(run_rank, args=(args,), nprocs=args.world,
                             join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 2 * TIMEOUT_S:
                raise TimeoutError("the ranks did not finish in time")
    except mp.ProcessRaisedException as e:
        print(f"distributed_cards: a rank failed: {e}", file=sys.stderr)
        return 1
    except mp.ProcessExitedException as e:
        print(f"distributed_cards: a rank exited: {e}", file=sys.stderr)
        return 1
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
