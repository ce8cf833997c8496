"""``examples/rag_serve_torch.py`` (the port's retrieval-augmented serving
flow) against ``examples/rag_serve.py``'s flow on the JAX package, on the
CPU, at the reduced qwen2 config in fp32.

The JAX init's weights (``init_train_state`` at PRNGKey(0), as the JAX
example draws them) are carried into the port by ``from_numpy_params``;
both flows embed the same zipf documents and queries (mean logits), index
them in a 4-shard exact collection, retrieve the top 3 of each query and
decode 8 tokens greedily after the best document.  The retrieved ids must
be the same, and the generated tokens too.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import Database as JDatabase
from repro.api import VectorField as JVectorField
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data.synthetic import zipf_tokens
from repro.models import init_train_state as j_init_train_state
from repro.models import make_serve_step as j_make_serve_step
from repro.models.model import forward as j_forward
from repro.models.model import init_decode_state as j_init_decode_state
from repro_torch.configs import get_smoke_config
from repro_torch.models import from_numpy_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import rag_serve_torch as rag  # noqa: E402


def _jax_flow(cfg, params):
    """``examples/rag_serve.py``'s steps on the JAX package at ``cfg``."""
    rng = np.random.RandomState(0)
    docs = zipf_tokens(rng, (rag.N_DOCS, rag.DOC_LEN), cfg.vocab_size)

    def embed(tokens):
        logits, _ = j_forward(params, {"tokens": jnp.asarray(tokens)}, cfg)
        return np.asarray(logits.mean(axis=1), dtype=np.float32)

    emb = embed(docs)
    db = JDatabase()
    col = db.create_collection(
        name="docs", vector=JVectorField(dim=emb.shape[1], index="flat"),
        shards=rag.N_SHARDS)
    col.upsert([f"doc-{i}" for i in range(rag.N_DOCS)], emb)
    queries = zipf_tokens(rng, (rag.N_QUERIES, rag.DOC_LEN), cfg.vocab_size)
    retrieved = [[h.id for h in col.query(q).top_k(rag.TOP_K).run()]
                 for q in embed(queries)]
    db.close()
    best = np.array([int(r[0].split("-")[1]) for r in retrieved])
    ctx = np.concatenate([docs[best], queries], axis=1)
    serve = jax.jit(j_make_serve_step(cfg))
    state = j_init_decode_state(cfg, rag.N_QUERIES, ctx.shape[1] + 16)
    for t in range(ctx.shape[1] - 1):
        _, state = serve(params, state, jnp.asarray(ctx[:, t:t + 1]))
    tok = jnp.asarray(ctx[:, -1:])
    gen = []
    for _ in range(rag.GEN_TOKENS):
        tok, state = serve(params, state, tok)
        gen.append(np.asarray(tok)[:, 0])
    return retrieved, np.stack(gen, axis=1)


def test_rag_flow_matches_the_jax_flow():
    jcfg = j_get_smoke_config("qwen2-1.5b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2-1.5b").with_overrides(dtype="float32")
    params = j_init_train_state(jax.random.PRNGKey(0), jcfg).params
    want_ids, want_gen = _jax_flow(jcfg, params)
    model = from_numpy_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    out = rag.rag_flow(cfg, model, device=torch.device("cpu"),
                       log=lambda *_: None)
    assert out["retrieved"] == want_ids
    assert np.array_equal(out["generated"], want_gen)
    assert len(out["shards"]) == rag.N_SHARDS


def test_rag_example_runs_on_the_cpu(capsys):
    rag.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "scatter-gather across 4 shards" in text
    assert text.count(" -> [") == rag.N_QUERIES
