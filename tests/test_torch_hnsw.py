"""The port's HNSW search and bulk builder against the JAX package.

Search: on a graph the JAX package built (loaded through its state_dict),
the port's lockstep batched search returns the JAX search's ids, distances
and per-query iteration counts, across widths {1, 2, 4} × {l2, dot}, and the
numpy oracle's ids.  Build: with the same seed the port's bulk builder gives
the JAX builder's graph where no k-means centroids are drawn (level mode,
coarse mode with one cluster), and the same recall where they are.  The
traps of the translation each have a test: ties (stable sorts, top-k),
the lockstep loop (max_iters freezing), visited bits in the top bit of a
word, the device kNN, and the k-means step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HNSWConfig as JHNSWConfig
from repro.core import bulk_build_device as j_bulk_build
from repro.core import exact_knn, recall_at_k
from repro.core import hnsw_bulk as jbulk
from repro.core import pq as jpq
from repro.core.hnsw_build import PackedHNSW as JPackedHNSW
from repro.core.hnsw_build import knn_ids_dists as j_knn
from repro.core.hnsw_build import preprocess_vectors
from repro.core.hnsw_search import search as j_search
from repro.core.hnsw_search import search_numpy_reference
from repro.core.hnsw_search import to_device as j_to_device
from repro.data.synthetic import gaussian_mixture
from repro_torch.core import HNSWConfig, PackedHNSW, bulk_build_device
from repro_torch.core import hnsw_bulk as pbulk
from repro_torch.core import pq as ppq
from repro_torch.core.hnsw_build import knn_ids_dists
from repro_torch.core.hnsw_search import search
from repro_torch.core.hnsw_search import \
    search_numpy_reference as p_search_numpy_reference
from repro_torch.core.hnsw_search import to_device

N, DIM = 900, 24
WIDTHS = (1, 2, 4)


@pytest.fixture(scope="module")
def corpus():
    return gaussian_mixture(N, DIM, n_clusters=15, scale=0.25, seed=3)


@pytest.fixture(scope="module")
def queries():
    return gaussian_mixture(24, DIM, n_clusters=15, scale=0.25, seed=11)


@pytest.fixture(scope="module", params=["cosine", "l2"])
def graphs(request, corpus):
    """(JAX-built PackedHNSW, the port's load of its state_dict)."""
    metric = request.param
    jp = j_bulk_build(corpus, JHNSWConfig(M=10, metric=metric, seed=0,
                                          build_batch=256, bulk_mode="level"))
    pp = PackedHNSW.from_state_dict(jp.state_dict(),
                                    HNSWConfig(M=10, metric=metric))
    return jp, pp


def _both(jp, pp, queries, **kw):
    gj, ml, metric = j_to_device(jp)
    gp, ml_p, metric_p = to_device(pp, "cpu")
    assert (ml, metric) == (ml_p, metric_p)
    q = preprocess_vectors(queries, jp.config.metric)
    jd, ji, jit = j_search(gj, jnp.asarray(q), max_level=ml, metric=metric,
                           with_iters=True, **kw)
    pd, pi, pit = search(gp, torch.as_tensor(q), max_level=ml, metric=metric,
                         with_iters=True, **kw)
    return (np.asarray(jd), np.asarray(ji), np.asarray(jit)), \
        (pd.numpy(), pi.numpy(), pit.numpy())


class TestSearchParity:
    @pytest.mark.parametrize("width", WIDTHS)
    def test_ids_and_iters_match_jax(self, graphs, queries, width):
        jp, pp = graphs
        (jd, ji, jit), (pd, pi, pit) = _both(jp, pp, queries, k=10, ef=48,
                                             expansion_width=width)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pit, jit)
        np.testing.assert_allclose(pd, jd, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("width", WIDTHS)
    def test_matches_numpy_reference(self, graphs, queries, width):
        """The port's copy of the host oracle equals the JAX package's, and
        the lockstep search returns its ids on at least 95 % of queries
        (the oracle sums distances in numpy's order)."""
        jp, pp = graphs
        gp, ml, metric = to_device(pp, "cpu")
        q = preprocess_vectors(queries, pp.config.metric)
        _, ids = search(gp, torch.as_tensor(q), k=10, ef=48, max_level=ml,
                        metric=metric, expansion_width=width)
        _, ids_np = p_search_numpy_reference(pp, queries, 10, 48,
                                             expansion_width=width)
        _, ids_jax = search_numpy_reference(jp, queries, 10, 48,
                                            expansion_width=width)
        np.testing.assert_array_equal(ids_np, ids_jax)
        assert (ids.numpy() == ids_np).all(1).mean() >= 0.95

    @pytest.mark.parametrize("max_iters", [1, 3, 7])
    def test_lockstep_freezes_like_vmap(self, graphs, queries, max_iters):
        """A query whose loop ends (frontier empty or budget spent) keeps
        its state while the batch steps on: ids and trip counts match."""
        jp, pp = graphs
        (jd, ji, jit), (pd, pi, pit) = _both(
            jp, pp, queries, k=8, ef=16, expansion_width=2,
            max_iters=max_iters)
        np.testing.assert_array_equal(pit, jit)
        assert pit.max() == max_iters
        np.testing.assert_array_equal(pi, ji)

    def test_visited_bits_in_the_top_word_bit(self):
        """A hand-made graph whose neighbours sit on bit 31 of their visited
        word (ids 31, 63, 95) and are shared between popped rows."""
        rng = np.random.RandomState(0)
        n, m0 = 96, 6
        vecs = rng.randn(n, 8).astype(np.float32)
        adj0 = np.full((n, m0), -1, np.int32)
        for i in range(n):
            nb = [(i + 1) % n, (i - 1) % n, 31, 63, 95, (i + 32) % n]
            nb = [x for x in dict.fromkeys(nb) if x != i][:m0]
            adj0[i, :len(nb)] = nb
        state = {"vectors": vecs, "adj0": adj0,
                 "upper_ids": np.array([5], np.int32),
                 "upper_adj": np.full((1, 1, 4), -1, np.int32),
                 "levels": np.zeros(n, np.int8),
                 "meta": np.array([5, 0, 1], np.int64)}
        jp = JPackedHNSW.from_state_dict(state, JHNSWConfig(M=4, metric="l2"))
        pp = PackedHNSW.from_state_dict(state, HNSWConfig(M=4, metric="l2"))
        q = rng.randn(5, 8).astype(np.float32)
        for width in (1, 3):
            (jd, ji, jit), (pd, pi, pit) = _both(jp, pp, q, k=12, ef=24,
                                                 expansion_width=width)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pit, jit)
            for row in pi:                     # each id found once
                real = row[row >= 0]
                assert len(set(real.tolist())) == len(real)


class TestDeviceKnn:
    @pytest.mark.parametrize("metric", ["l2", "dot"])
    @pytest.mark.parametrize("chunk,corpus_chunk", [(4096, None), (7, 13)])
    def test_matches_numpy(self, metric, chunk, corpus_chunk):
        rng = np.random.RandomState(4)
        x = rng.randn(300, 16).astype(np.float32)     # tie-free
        q = rng.randn(41, 16).astype(np.float32)
        ji, jd = j_knn(q, x, 9, metric=metric, chunk=chunk,
                       corpus_chunk=corpus_chunk)
        pi, pd = knn_ids_dists(torch.as_tensor(q), torch.as_tensor(x), 9,
                               metric=metric, chunk=chunk,
                               corpus_chunk=corpus_chunk)
        np.testing.assert_array_equal(pi.numpy(), ji)
        np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-4, atol=1e-4)


def _same_rows(a, b):
    return np.mean([set(r[r >= 0].tolist()) == set(s[s >= 0].tolist())
                    for r, s in zip(a, b)])


class TestBuildParity:
    @pytest.mark.parametrize("n,metric,kw", [
        (600, "cosine", dict(bulk_mode="level", build_batch=128)),
        (600, "l2", dict(bulk_mode="level", build_batch=128)),
        (600, "cosine", dict()),               # auto -> level, one batch
        (3000, "cosine", dict()),              # auto -> coarse, nlist = 1
    ])
    def test_graph_matches_jax(self, n, metric, kw):
        x = gaussian_mixture(n, DIM, n_clusters=20, scale=0.25, seed=0)
        jp = j_bulk_build(x, JHNSWConfig(M=12, metric=metric, seed=0, **kw))
        pp = bulk_build_device(x, HNSWConfig(M=12, metric=metric, seed=0,
                                             **kw), device="cpu")
        assert pp.build_info == jp.build_info
        assert _same_rows(pp.adj0, jp.adj0) >= 0.99
        np.testing.assert_array_equal(pp.levels, jp.levels)
        np.testing.assert_array_equal(pp.upper_adj, jp.upper_adj)
        assert (pp.entry_global, pp.max_level) == (jp.entry_global,
                                                   jp.max_level)

    def test_kmeans_build_recall_matches_jax(self):
        """n >= 12,288 draws k-means centroids (torch vs jax.random): held
        to recall within 0.02, not to identity."""
        n = 13_000
        x = gaussian_mixture(n, 32, n_clusters=20, scale=0.25, seed=0)
        qs = gaussian_mixture(200, 32, n_clusters=20, scale=0.25, seed=9)
        gt = exact_knn(qs, x, 10, metric="cosine")
        q = preprocess_vectors(qs, "cosine")
        jp = j_bulk_build(x, JHNSWConfig(metric="cosine", seed=0))
        pp = bulk_build_device(x, HNSWConfig(metric="cosine", seed=0),
                               device="cpu")
        assert pp.build_info["build_clusters"] == \
            jp.build_info["build_clusters"] == 2
        gj, ml, metric = j_to_device(jp)
        _, ji = j_search(gj, jnp.asarray(q), k=10, ef=64, max_level=ml,
                         metric=metric)
        gp, ml, metric = to_device(pp, "cpu")
        _, pi = search(gp, torch.as_tensor(q), k=10, ef=64, max_level=ml,
                       metric=metric)
        rj = recall_at_k(np.asarray(ji), gt)
        rp = recall_at_k(pi.numpy(), gt)
        assert abs(rp - rj) <= 0.02, (rp, rj)
        assert rp >= 0.8


class TestStableSorts:
    """jnp.argsort is stable; the prune's dedup and the capped merge's
    priority ranking depend on it."""

    def test_prune_batch_matches_jax_on_ties(self):
        rng = np.random.RandomState(1)
        n, b, c, d = 80, 16, 24, 8
        corpus = rng.randint(0, 3, (n, d)).astype(np.float32)   # tied rows
        q_ids = rng.randint(0, n, b).astype(np.int32)
        cand = rng.randint(-1, n + 2, (b, c)).astype(np.int32)  # PAD, OOR
        cand[:, 5] = cand[:, 0]                                  # dups
        cand[:, 6] = q_ids                                       # self
        cand_d = rng.randint(0, 4, (b, c)).astype(np.float32)    # ties
        for mode in ("l2", "dot"):
            for keep in (True, False):
                want = jbulk._prune_batch(
                    jnp.asarray(corpus), jnp.asarray(q_ids),
                    jnp.asarray(cand), jnp.asarray(cand_d), m=10, mode=mode,
                    keep_pruned=keep)
                got = pbulk._prune_batch(
                    torch.as_tensor(corpus), torch.as_tensor(q_ids),
                    torch.as_tensor(cand), torch.as_tensor(cand_d), m=10,
                    mode=mode, keep_pruned=keep)
                for w, g in zip(want, got):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_merge_cap_matches_jax_on_ties(self):
        rng = np.random.RandomState(2)
        n, m, e = 40, 6, 300
        adj = rng.randint(-1, n, (n + 1, m)).astype(np.int32)
        adj_d = rng.randint(0, 3, (n + 1, m)).astype(np.float32)
        adj_p = rng.randint(0, 2, (n + 1, m)).astype(np.int32)
        tgt = rng.randint(-1, n + 1, e).astype(np.int32)
        src = rng.randint(-1, n + 1, e).astype(np.int32)
        dd = rng.randint(0, 3, e).astype(np.float32)
        dd[::17] = np.inf
        pp = rng.randint(0, 2, e).astype(np.int32)
        want = jbulk._merge_cap(*(jnp.asarray(a) for a in
                                  (adj, adj_d, adj_p, tgt, src, dd, pp)), m=m)
        got = pbulk._merge_cap(*(torch.as_tensor(a) for a in
                                 (adj, adj_d, adj_p, tgt, src, dd, pp)), m=m)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])

    def test_levels_and_edges(self):
        cfg_j, cfg_p = JHNSWConfig(M=8), HNSWConfig(M=8)
        a = jbulk._sample_levels(500, cfg_j, np.random.RandomState(3))
        b = pbulk._sample_levels(500, cfg_p, np.random.RandomState(3))
        np.testing.assert_array_equal(a, b)
        rng = np.random.RandomState(4)
        sel = rng.randint(-1, 50, (7, 5)).astype(np.int32)
        sd = rng.rand(7, 5).astype(np.float32)
        sp = rng.randint(0, 2, (7, 5)).astype(np.int32)
        nodes = rng.randint(0, 50, 7)
        want = jbulk._edges_both_ways(sel, sd, sp, nodes)
        got = pbulk._edges_both_ways(*(torch.as_tensor(a) for a in
                                       (sel, sd, sp, nodes)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)


def test_lloyd_step_matches_jax():
    """Same data and initial centroids -> same assignment and centroids
    (the seeding differs by design: torch.Generator vs jax.random)."""
    rng = np.random.RandomState(6)
    x = rng.randn(500, 12).astype(np.float32)
    c = x[rng.choice(500, 9, replace=False)]
    jc, ja = jpq._lloyd_step(jnp.asarray(x), jnp.asarray(c))
    pc, pa = ppq._lloyd_step(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    cent = ppq._fit_one_subspace(gen, torch.as_tensor(x), 9, 5)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(cent, ppq._fit_one_subspace(gen, torch.as_tensor(x),
                                                   9, 5))
