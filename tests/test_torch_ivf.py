"""The port's IVF index and IVF engines against the JAX package's.

The same seeded numpy inputs go through ``repro.core.ivf`` and
``repro_torch.core.ivf``: lists built from the same centroids are bit-equal
to the reference loop's, overflow included (a ``list_slack`` small enough
that lists fill, and one under 1 that drops rows); ``_ivf_search`` returns
the same ids (distances within 1e-5 relative), with nprobe past nlist / 2
and k past the candidate count; states load both ways.  JAX IVF engines
(none / PQ / BQ, cosine and l2) with delta rows and metadata load into the
port's engine, which returns their hits plain, under a ~50 % mask, under a
~5 % mask (the flat route) and for delta rows, with the rescore on and off;
the port's state loads back into the JAX engine.  The port's own k-means
is held to recall.  Mirrors the IVF cases of ``tests/test_engine.py`` and
``tests/test_segments.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Predicate as JPredicate
from repro.core import bq as jbq
from repro.core import pq as jpq
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import QuantixarEngine as JEngine
from repro.core.ivf import IVFConfig as JIVFConfig
from repro.core.ivf import IVFIndex as JIVFIndex
from repro.data.synthetic import gaussian_mixture
from repro_torch.core import (BQConfig, EngineConfig, IVFConfig, IVFIndex,
                              PQConfig, Predicate, QuantixarEngine, exact_knn)
from repro_torch.core.ivf import PAD, _ivf_search

N, N_DELTA, DIM, K = 1500, 40, 24, 10
NLIST = 16
CASES = ("plain", "mask50", "mask5", "delta")


def _data():
    x = gaussian_mixture(N + N_DELTA, DIM, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(16, DIM, n_clusters=15, scale=0.3, seed=2)
    meta = [{"tag": int(i % 20)} for i in range(N + N_DELTA)]
    return x, q, meta


def _pair(metric="cosine", **kw):
    """(JAX index trained on the data, port index holding its centroids)."""
    x, _, _ = _data()
    j = JIVFIndex(JIVFConfig(nlist=NLIST, metric=metric, **kw))
    j.train(jnp.asarray(x[:N]))
    t = IVFIndex(IVFConfig(nlist=NLIST, metric=metric, **kw), device="cpu")
    t.centroids = torch.as_tensor(np.array(j.centroids))
    return j, t, x[:N]


class TestBuildLists:
    @pytest.mark.parametrize("metric", ["cosine", "l2"])
    @pytest.mark.parametrize("slack", [1.5, 1.02, 0.5],
                             ids=["default", "overflow", "drops"])
    def test_lists_bit_equal_to_reference(self, metric, slack):
        """From the same centroids, the same (nlist, max_list) lists as the
        reference's row loop: at the default slack, at a slack that forces
        overflow into next-nearest lists, and below 1, where rows that find
        every list full are dropped."""
        j, t, x = _pair(metric, list_slack=slack)
        j.build_lists(jnp.asarray(x))
        t.build_lists(x)
        want = np.asarray(j.lists)
        assert t.lists.dtype == torch.int32
        np.testing.assert_array_equal(t.lists.numpy(), want)
        np.testing.assert_array_equal(t.list_sizes, j.list_sizes)
        max_list = want.shape[1]
        if slack < 1.5:
            assert (j.list_sizes == max_list).sum() > 1    # overflow happened
        if slack < 1:
            assert (want != PAD).sum() < N

    @pytest.mark.parametrize("slack", [1.5, 1.02, 0.5])
    def test_lists_bit_equal_integer_rows(self, slack):
        """Integer rows and centroids: every distance exact, exact ties
        everywhere (to the lower centroid in both), heavy overflow."""
        rng = np.random.RandomState(4)
        x = rng.randint(-4, 5, (6000, 24)).astype(np.float32)
        cent = x[rng.choice(6000, 32, replace=False)]
        j = JIVFIndex(JIVFConfig(nlist=32, metric="l2", list_slack=slack))
        j.centroids = jnp.asarray(cent)
        j.build_lists(jnp.asarray(x))
        t = IVFIndex(IVFConfig(nlist=32, metric="l2", list_slack=slack),
                     device="cpu")
        t.centroids = torch.as_tensor(cent)
        t.build_lists(x)
        np.testing.assert_array_equal(t.lists.numpy(), np.asarray(j.lists))
        assert (j.list_sizes == t.lists.shape[1]).sum() > 1

    def test_lists_cover_corpus(self):
        """Every row lands in exactly one list (tests/test_engine.py's
        test_ivf_lists_cover_corpus, on the port's own training)."""
        _, _, x = _pair()
        t = IVFIndex(IVFConfig(nlist=NLIST), device="cpu")
        t.train(x)
        t.build_lists(x)
        members = t.lists.numpy()
        members = members[members != PAD]
        assert len(members) == N and len(set(members.tolist())) == N


class TestSearch:
    @pytest.mark.parametrize("metric", ["cosine", "l2"])
    @pytest.mark.parametrize("nprobe,k", [(4, 10), (12, 50), (16, 100)],
                             ids=["nprobe4", "past-half", "all-lists"])
    def test_search_matches_reference(self, metric, nprobe, k):
        j, t, x = _pair(metric, nprobe=nprobe)
        j.build_lists(jnp.asarray(x))
        t.build_lists(x)
        _, q, _ = _data()
        want_d, want_i = j.search(jnp.asarray(x), jnp.asarray(q), k)
        got_d, got_i = t.search(x, q, k)
        assert got_i.dtype == torch.int32
        assert tuple(got_d.shape) == np.asarray(want_d).shape
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   rtol=1e-5, atol=1e-6)

    def test_search_k_past_candidates_integer_rows(self):
        """k past C = nprobe * max_list, on integer rows whose norm
        expansion is exact: ties everywhere, PAD slots at +inf with id -1,
        and every id equal to the reference's."""
        rng = np.random.RandomState(5)
        x = rng.randint(-4, 5, (300, 8)).astype(np.float32)
        q = rng.randint(-4, 5, (7, 8)).astype(np.float32)
        cent = x[rng.choice(300, 6, replace=False)]
        lists_j = JIVFIndex(JIVFConfig(nlist=6, metric="l2", list_slack=1.2))
        lists_j.centroids = jnp.asarray(cent)
        lists_j.build_lists(jnp.asarray(x))
        lists = np.asarray(lists_j.lists)
        for nprobe in (1, 4, 6):
            c = nprobe * lists.shape[1]
            from repro.core.ivf import _ivf_search as j_ivf_search
            wd, wi = j_ivf_search(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(cent), jnp.asarray(lists),
                                  c + 7, nprobe)
            gd, gi = _ivf_search(torch.as_tensor(x), torch.as_tensor(q),
                                 torch.as_tensor(cent),
                                 torch.as_tensor(lists), c + 7, nprobe)
            assert gd.shape == (7, c)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))

    def test_query_chunks_equal_one_block(self, monkeypatch):
        """The candidate block is cut into query chunks by a byte budget;
        results equal one block's."""
        from repro_torch.core import ivf as ivf_mod
        _, t, x = _pair(nprobe=6)
        t.build_lists(x)
        _, q, _ = _data()
        whole = t.search(x, q, 20)
        monkeypatch.setattr(ivf_mod, "IVF_BLOCK_BYTES", 1)
        parts = t.search(x, q, 20)
        for a, b in zip(whole, parts):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


class TestState:
    def test_state_dict_both_ways(self):
        j, t, x = _pair()
        j.build_lists(jnp.asarray(x))
        t2 = IVFIndex(IVFConfig(nlist=NLIST), device="cpu")
        t2.load_state_dict(j.state_dict())
        np.testing.assert_array_equal(t2.list_sizes, j.list_sizes)
        back = JIVFIndex(JIVFConfig(nlist=NLIST))
        back.load_state_dict(t2.state_dict())
        for key, v in j.state_dict().items():
            got = back.state_dict()[key]
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v)
        np.testing.assert_array_equal(back.list_sizes, j.list_sizes)


# ------------------------------------------------------------------ engines
def _configs(quant, metric):
    kw = dict(dim=DIM, metric=metric, index="ivf", quantization=quant)
    return (JEngineConfig(ivf=JIVFConfig(nlist=NLIST, nprobe=4),
                          pq=jpq.PQConfig(m=6, k=32, iters=8),
                          bq=jbq.BQConfig(bits=64), **kw),
            EngineConfig(ivf=IVFConfig(nlist=NLIST, nprobe=4),
                         pq=PQConfig(m=6, k=32, iters=8),
                         bq=BQConfig(bits=64), **kw))


@pytest.fixture(scope="module",
                params=[("none", "cosine"), ("none", "l2"), ("pq", "cosine"),
                        ("pq", "l2"), ("bq", "cosine")],
                ids=["none-cosine", "none-l2", "pq-cosine", "pq-l2",
                     "bq-cosine"])
def engines(request):
    """(JAX IVF engine, port engine loaded from its state_dict, data)."""
    x, q, meta = _data()
    jcfg, pcfg = _configs(*request.param)
    jeng = JEngine(jcfg)
    jeng.add(x[:N], meta[:N])
    jeng.build()
    jeng.add(x[N:], meta[N:])               # stays in the delta segment
    assert jeng.delta_rows == N_DELTA
    peng = QuantixarEngine.from_state_dict(pcfg, jeng.state_dict(),
                                           device="cpu")
    return jeng, peng, x, q


def _search_args(case, x, q):
    rng = np.random.RandomState(3)
    if case == "plain":
        return q, {}
    if case == "delta":
        return x[N:N + 12] + 1e-3, {}
    sel = 0.5 if case == "mask50" else 0.05
    return q, {"mask": rng.rand(N + N_DELTA) < sel}


def _assert_same_hits(a, b):
    (da, ia), (db, ib) = a, b
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)


class TestEngineParity:
    @pytest.mark.parametrize("rescore", [True, False])
    @pytest.mark.parametrize("case", CASES)
    def test_hits_match_jax(self, engines, case, rescore):
        jeng, peng, x, q = engines
        queries, kw = _search_args(case, x, q)
        got = peng.search(queries, K, rescore=rescore, **kw)
        _assert_same_hits(got, jeng.search(queries, K, rescore=rescore, **kw))
        if case == "delta" and (rescore or peng.config.quantization == "none"):
            assert (got[1][:, 0] == N + np.arange(12)).all()
        if case.startswith("mask"):
            ok = got[1] >= 0
            assert kw["mask"][got[1][ok]].all()

    def test_filter_matches_jax(self, engines):
        jeng, peng, _, q = engines
        _assert_same_hits(peng.search(q, K, flt=Predicate("tag", "lt", 4)),
                          jeng.search(q, K, flt=JPredicate("tag", "lt", 4)))

    def test_state_and_stats_match(self, engines):
        jeng, peng, _, _ = engines
        for key in ("ivf_lists", "ivf_mean_list", "ivf_max_list",
                    "sealed_rows", "delta_rows"):
            assert peng.stats()[key] == jeng.stats()[key], key
        state, want = peng.state_dict(), jeng.state_dict()
        assert sorted(state) == sorted(want)
        for key in ("ivf.centroids", "ivf.lists"):
            assert state[key].dtype == want[key].dtype
            np.testing.assert_array_equal(state[key], want[key])

    def test_state_dict_round_trips_into_jax(self, engines):
        jeng, peng, x, q = engines
        back = JEngine.from_state_dict(jeng.config, peng.state_dict())
        assert back.delta_rows == N_DELTA
        for case in CASES:
            queries, kw = _search_args(case, x, q)
            _assert_same_hits(back.search(queries, K, **kw),
                              jeng.search(queries, K, **kw))

    def test_seal_keeps_centroids_and_matches_jax(self, engines):
        """seal() folds the delta into new lists over the same centroids
        (no k-means); the port's lists stay the reference's."""
        jeng, peng, x, q = engines
        jeng2 = JEngine.from_state_dict(jeng.config, jeng.state_dict())
        peng2 = QuantixarEngine.from_state_dict(peng.config,
                                                peng.state_dict(),
                                                device="cpu")
        assert jeng2.seal() and peng2.seal()
        np.testing.assert_array_equal(peng2._ivf.lists.numpy(),
                                      np.asarray(jeng2._ivf.lists))
        assert peng2.delta_rows == 0 and peng2.stats()["seals"] == 1
        _assert_same_hits(peng2.search(q, K), jeng2.search(q, K))


class TestOwnBuild:
    @pytest.mark.parametrize("quant", ["none", "pq", "bq"])
    def test_own_training_reaches_recall(self, quant):
        """The port's own k-means (its generator) is held to recall against
        an exact top-k, as tests/test_engine.py holds the reference's
        (0.6 for IVF; nprobe 16 of 32 lists > 0.9 unquantized)."""
        x, q, meta = _data()
        eng = QuantixarEngine(EngineConfig(
            dim=DIM, index="ivf", quantization=quant,
            ivf=IVFConfig(nlist=32, nprobe=16),
            pq=PQConfig(m=6, k=32, iters=8), bq=BQConfig(bits=64)),
            device="cpu")
        marks = []
        eng.add(x[:N], meta[:N])
        eng.build(progress=lambda phase, *_: marks.append(phase))
        assert marks[-2:] == ["kmeans", "lists"]
        _, ids = eng.search(q, K)
        gt = exact_knn(q, x[:N], K, metric="cosine")
        recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)])
        assert recall > (0.9 if quant == "none" else 0.6), recall
        s = eng.stats()
        assert s["ivf_lists"] == 32 and s["ivf_mean_list"] == N / 32
        # add after build rides the delta: no k-means, no new lists
        eng.add(x[N:], meta[N:])
        _, ids = eng.search(x[N:N + 4], 5)
        for r in range(4):
            assert N + r in set(ids[r].tolist())
        assert eng.stats()["index_builds"] == 1
        # a persisted engine answers the same (test_segments.py's
        # test_quantized_ivf_roundtrip_identical)
        d1, i1 = eng.search(q, K)
        eng2 = QuantixarEngine.from_state_dict(eng.config, eng.state_dict(),
                                               device="cpu")
        d2, i2 = eng2.search(q, K)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)
        assert eng2.stats()["ivf_mean_list"] > 0

    def test_nprobe_recall_knob(self):
        x, q, _ = _data()
        gt = exact_knn(q, x[:N], K, metric="cosine")

        def recall_at(nprobe):
            eng = QuantixarEngine(EngineConfig(
                dim=DIM, index="ivf", ivf=IVFConfig(nlist=32, nprobe=nprobe)),
                device="cpu")
            eng.add(x[:N])
            _, ids = eng.search(q, K)
            return np.mean([len(set(a) & set(b)) / K
                            for a, b in zip(ids, gt)])

        low, high = recall_at(2), recall_at(16)
        assert high > low and high > 0.9, (low, high)
