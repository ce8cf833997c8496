"""Retrieval-augmented serving on the PyTorch port: an LM backbone embeds
documents, a sharded collection indexes them, and a query plan retrieves
before decode -- ``examples/rag_serve.py``'s flow on ``repro_torch``.

    PYTHONPATH=src python examples/rag_serve_torch.py              # the card
    PYTHONPATH=src python examples/rag_serve_torch.py --device cpu

The reduced qwen2 config (``--full`` for qwen2-1.5b's published size) is
the embedder and the generator, with random weights from a seeded
``torch.Generator``.  Each document is a token sequence whose embedding is
its mean next-token distribution (the logits averaged over its positions);
the documents live in one ``ShardedCollection`` (4 shards, exact flat
search, ids "doc-<i>"), every query scatters to the shards and merges the
global top-3, and each query is then decoded greedily after the best
document: a teacher-forced prefill of document + query, then 8 new tokens.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import Database, VectorField  # noqa: E402
from repro_torch.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch.models import (forward, init_decode_state,  # noqa: E402
                                make_serve_step)

N_DOCS, DOC_LEN, N_SHARDS = 512, 24, 4
N_QUERIES, TOP_K, GEN_TOKENS = 8, 3, 8
EMBED_BATCH = 64      # documents a forward: a full-size vocab's logits


@torch.no_grad()
def embed(model, cfg, tokens: np.ndarray, device) -> np.ndarray:
    """(N, L) tokens -> (N, V) fp32: the mean of each sequence's logits."""
    out = []
    for lo in range(0, len(tokens), EMBED_BATCH):
        t = torch.as_tensor(tokens[lo:lo + EMBED_BATCH], device=device)
        logits, _ = forward(model, {"tokens": t}, cfg)
        out.append(logits.mean(dim=1).cpu().numpy())
    return np.concatenate(out).astype(np.float32)


@torch.no_grad()
def rag_flow(cfg, model, *, device, seed: int = 0, log=print) -> dict:
    """The flow on ``model``: returns {"retrieved": the top-3 ids of each
    query, "scores": their distances, "best": each query's best document,
    "generated": (queries, GEN_TOKENS) greedy ids, "retrieve_s", "shards",
    "doc_emb" / "query_emb": the embeddings searched}."""
    rng = np.random.RandomState(seed)
    docs = zipf_tokens(rng, (N_DOCS, DOC_LEN), cfg.vocab_size)
    log("embedding documents ...")
    emb = embed(model, cfg, docs, device)

    db = Database(device=device)
    try:
        col = db.create_collection(
            name="docs", vector=VectorField(dim=emb.shape[1], index="flat"),
            shards=N_SHARDS)
        col.upsert([f"doc-{i}" for i in range(N_DOCS)], emb)
        queries = zipf_tokens(rng, (N_QUERIES, DOC_LEN), cfg.vocab_size)
        q_emb = embed(model, cfg, queries, device)
        t0 = time.perf_counter()
        retrieved = [col.query(q).top_k(TOP_K).run() for q in q_emb]
        retrieve_s = time.perf_counter() - t0
        log(f"retrieved top-{TOP_K} docs for {N_QUERIES} queries in "
            f"{retrieve_s:.2f}s (scatter-gather across {col.num_shards} "
            f"shards)")
        log(f"retrieval plan: {col.query(q_emb[0]).top_k(TOP_K).explain()}")
        shards = [f"{s['shard']}: {s['rows']} rows"
                  for s in col.shard_stats()]
        log(f"shard layout: {', '.join(shards)}")
    finally:
        db.close()

    ids = [[h.id for h in hits] for hits in retrieved]
    scores = [[h.score for h in hits] for hits in retrieved]
    best = np.array([int(row[0].split("-")[1]) for row in ids])
    ctx = np.concatenate([docs[best], queries], axis=1)
    serve = make_serve_step(cfg)
    state = init_decode_state(cfg, N_QUERIES, ctx.shape[1] + 2 * GEN_TOKENS,
                              device=device)
    ctx_t = torch.as_tensor(ctx, device=device)
    for t in range(ctx.shape[1] - 1):            # teacher-forced prefill
        _, state = serve(model, state, ctx_t[:, t:t + 1])
    tok = ctx_t[:, -1:]
    gen = []
    for _ in range(GEN_TOKENS):
        tok, state = serve(model, state, tok)
        gen.append(tok[:, 0].cpu().numpy())
    generated = np.stack(gen, axis=1)
    log("generated continuations (token ids):")
    for i, row in enumerate(generated):
        log(f"  q{i}: doc={int(best[i])} -> {row.tolist()}")
    return {"retrieved": ids, "scores": scores, "best": best.tolist(),
            "generated": generated, "retrieve_s": retrieve_s,
            "shards": shards, "doc_emb": emb, "query_emb": q_emb}


def main(argv=None) -> None:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on a host "
                         "without a card)")
    ap.add_argument("--full", action="store_true",
                    help="qwen2-1.5b at its published size")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (get_config if args.full else get_smoke_config)("qwen2-1.5b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = init_params(cfg, generator=gen, device=dev)
    rag_flow(cfg, model, device=dev, seed=args.seed)


if __name__ == "__main__":
    main()
