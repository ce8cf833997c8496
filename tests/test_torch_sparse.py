"""The port's BM25 sparse index (``repro_torch.core.sparse``) against the
JAX package's (``repro.core.sparse``) on the CPU.

The same texts, made from a seed, go into both indexes: the numpy scores,
ranks, statistics and state dicts are equal exactly (the port's copy runs
the same float64 arithmetic), and the port's device scorer ``scores_torch``
(float32 ``index_add_``, here on the CPU) agrees with the numpy scores and
with the JAX package's ``scores_jax`` to float32 accumulation.
"""

import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro_torch.core import sparse as tsp

WORDS = ("quick fox dog vector index search dense sparse fusion rank token "
         "query the and of hybrid score merge").split()
QUERIES = ("quick fox", "vector index search", "fusion rank token",
           "quick quick dog", "the and of", "missingword", "Hybrid SCORE")
# float32 contributions summed in another order than the float64 numpy path
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _corpus(seed, n, empty_every=7):
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n):
        if empty_every and i % empty_every == 3:
            texts.append(None if i % 2 else "")
        else:
            texts.append(" ".join(rng.choice(WORDS, rng.integers(1, 9))))
    return texts


def _both(texts, seal_at=None, **cfg):
    out = []
    for mod in (jsp, tsp):
        index = mod.SparseIndex(mod.TokenizerConfig(**cfg))
        if seal_at is None:
            index.add(texts)
        else:
            index.add(texts[:seal_at])
            index.seal()
            index.add(texts[seal_at:])
        out.append(index)
    return out


@pytest.mark.parametrize("seal_at", [None, 25])
@pytest.mark.parametrize("cfg", [{}, {"lowercase": False, "min_token_len": 3,
                                      "stopwords": ()}])
def test_scores_and_ranks_equal(seal_at, cfg):
    texts = _corpus(0, 60)
    jidx, tidx = _both(texts, seal_at=seal_at, **cfg)
    mask = np.random.RandomState(1).rand(60) > 0.3
    for q in QUERIES:
        toks = jidx.config.query_tokens(q)
        assert tidx.config.query_tokens(q) == toks
        np.testing.assert_array_equal(tidx.scores(toks), jidx.scores(toks))
        for m in (None, mask):
            jd, jr = jidx.search(q, 10, mask=m)
            td, tr = tidx.search(q, 10, mask=m)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(
            tidx.scores(toks), tsp.bm25_reference(texts, q, tidx.config))
    assert tidx.stats() == jidx.stats()
    assert tidx.term_stats(["quick", "fox"]) == jidx.term_stats(
        ["quick", "fox"])


def test_scores_torch_matches_numpy_and_jax():
    texts = _corpus(2, 80)
    jidx, tidx = _both(texts, seal_at=50)
    for q in QUERIES:
        toks = tidx.config.query_tokens(q)
        got = tidx.scores_torch(toks, device="cpu")
        np.testing.assert_allclose(got, tidx.scores(toks), **F32_TOL)
        np.testing.assert_allclose(got, jidx.scores_jax(toks), **F32_TOL)
        d, rows = tidx.search(q, 8, backend="torch", device="cpu")
        nd, nrows = tidx.search(q, 8)
        np.testing.assert_allclose(d, nd, **F32_TOL)
        # equal ranks, but for rows whose scores tie within float32
        for a, b, s in zip(rows, nrows, nd):
            assert a == b or abs(got[a] - got[b]) <= 1e-5 * abs(s)
    with pytest.raises(ValueError, match="backend"):
        tidx.search("quick", 3, backend="jax")


def test_scores_torch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = tsp.SparseIndex()
    index.add(["quick fox"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index.search("quick", 1, backend="torch")


@pytest.mark.parametrize("writer,reader", [(jsp, tsp), (tsp, jsp)])
def test_state_dict_crosses_packages(writer, reader):
    texts = _corpus(3, 50)
    index = writer.SparseIndex()
    index.add(texts[:30])
    index.seal()
    index.add(texts[30:40])              # stays in the delta
    loaded = reader.SparseIndex.from_state_dict(index.state_dict())
    assert loaded.sealed_postings == index.sealed_postings
    assert loaded.delta_postings == index.delta_postings
    for q in QUERIES:
        np.testing.assert_array_equal(loaded.search(q, 10)[1],
                                      index.search(q, 10)[1])
    index.add(texts[40:])                # both keep absorbing upserts
    loaded.add(texts[40:])
    for q in QUERIES:
        np.testing.assert_array_equal(loaded.search(q, 10)[0],
                                      index.search(q, 10)[0])
    got, want = loaded.state_dict(), index.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_aggregated_corpus_stats_equal():
    texts = _corpus(4, 60)
    parts = []
    for lo in (0, 20, 40):
        jidx, tidx = _both(texts[lo:lo + 20])
        toks = jidx.config.query_tokens("quick fox vector")
        assert tidx.term_stats(toks) == jidx.term_stats(toks)
        parts.append((jidx, tidx, jidx.term_stats(toks)))
    jstats = jsp.CorpusStats.aggregate([p[2] for p in parts])
    tstats = tsp.CorpusStats.aggregate([p[2] for p in parts])
    assert (tstats.docs_with_text, tstats.avgdl, tstats.df) \
        == (jstats.docs_with_text, jstats.avgdl, jstats.df)
    for jidx, tidx, _ in parts:
        np.testing.assert_array_equal(
            tidx.search("quick fox vector", 5, stats=tstats)[1],
            jidx.search("quick fox vector", 5, stats=jstats)[1])
