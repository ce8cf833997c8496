"""The port's PQ and BQ engines against the JAX engine.

A JAX engine with ``quantization="pq"`` or ``"bq"`` is bulk-built, takes
delta rows and metadata, and is saved with ``state_dict``; the port's engine
loads that state (codebooks / hyperplanes and mean, codes, graph, delta) and
returns the JAX engine's hits for plain queries, under a ~50 % mask
(code-domain HNSW), under a ~5 % mask (the quantized flat route) and for
delta rows, with the exact rescore on and off, at widths {1, 4}.  The
port's state_dict loads back into the JAX engine with the same hits.  The
port's own build (its own quantizer training) reaches the JAX engine's own
recall on the same data within 0.05.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import HNSWConfig as JHNSWConfig
from repro.core import Predicate as JPredicate
from repro.core import bq as jbq
from repro.core import pq as jpq
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import QuantixarEngine as JEngine
from repro.data.synthetic import gaussian_mixture
from repro_torch.core import (BQConfig, EngineConfig, HNSWConfig, PQConfig,
                              Predicate, QuantixarEngine, exact_knn,
                              recall_at_k)
from repro_torch.kernels import beam_gather_adc as bga_mod

N, N_DELTA, DIM, K = 1500, 40, 24, 10
CASES = ("plain", "mask50", "mask5", "delta")


def _configs(quant, metric="cosine"):
    kw = dict(dim=DIM, metric=metric, builder="bulk", quantization=quant)
    return (JEngineConfig(hnsw=JHNSWConfig(M=10, seed=0),
                          pq=jpq.PQConfig(m=6, k=32, iters=8),
                          bq=jbq.BQConfig(bits=64), **kw),
            EngineConfig(hnsw=HNSWConfig(M=10, seed=0),
                         pq=PQConfig(m=6, k=32, iters=8),
                         bq=BQConfig(bits=64), **kw))


def _data():
    x = gaussian_mixture(N + N_DELTA, DIM, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(16, DIM, n_clusters=15, scale=0.3, seed=2)
    meta = [{"tag": int(i % 20)} for i in range(N + N_DELTA)]
    return x, q, meta


@pytest.fixture(scope="module",
                params=[("pq", "cosine"), ("bq", "cosine"), ("pq", "l2")],
                ids=["pq-cosine", "bq-cosine", "pq-l2"])
def engines(request):
    """(JAX engine, port engine loaded from its state_dict, data)."""
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
    np.testing.assert_allclose(da, db, rtol=2e-4, atol=2e-4)


class TestStateDictParity:
    @pytest.mark.parametrize("width", [1, 4])
    @pytest.mark.parametrize("rescore", [True, False])
    @pytest.mark.parametrize("case", CASES)
    def test_hits_match_jax(self, engines, case, rescore, width):
        jeng, peng, x, q = engines
        queries, kw = _search_args(case, x, q)
        kw.update(rescore=rescore, expansion_width=width)
        got = peng.search(queries, K, **kw)
        _assert_same_hits(got, jeng.search(queries, K, **kw))
        if case == "delta" and rescore:
            assert (got[1][:, 0] == N + np.arange(12)).all()
        if case.startswith("mask"):
            ok = got[1] >= 0
            assert kw["mask"][got[1][ok]].all()

    def test_filter_matches_jax(self, engines):
        jeng, peng, _, q = engines
        for rescore in (True, False):
            _assert_same_hits(
                peng.search(q, K, flt=Predicate("tag", "lt", 4),
                            rescore=rescore),
                jeng.search(q, K, flt=JPredicate("tag", "lt", 4),
                            rescore=rescore))

    def test_state_dict_round_trips_into_jax(self, engines):
        jeng, peng, x, q = engines
        state = peng.state_dict()
        want = jeng.state_dict()
        assert sorted(state) == sorted(want)
        assert state["codes"].dtype == want["codes"].dtype
        np.testing.assert_array_equal(state["codes"], want["codes"])
        back = JEngine.from_state_dict(jeng.config, state)
        assert back.delta_rows == N_DELTA
        for case in CASES:
            queries, kw = _search_args(case, x, q)
            _assert_same_hits(back.search(queries, K, **kw),
                              peng.search(queries, K, **kw))

    def test_stats(self, engines):
        jeng, peng, _, _ = engines
        js, ps = jeng.stats(), peng.stats()
        for key in ("n", "sealed_rows", "delta_rows", "mean_deg0",
                    "max_level", "compression", "quantization"):
            assert ps[key] == js[key]


@pytest.mark.parametrize("quant", ["pq", "bq"])
def test_flat_index_matches_jax(quant):
    """index="flat" with codes: every search is the quantized flat scan
    (+ rescore); loaded from the JAX state it returns the JAX hits."""
    x, q, _ = _data()
    jcfg, pcfg = _configs(quant)
    jcfg = dataclasses.replace(jcfg, index="flat")
    pcfg = dataclasses.replace(pcfg, index="flat")
    jeng = JEngine(jcfg)
    jeng.add(x)
    jeng.build()
    peng = QuantixarEngine.from_state_dict(pcfg, jeng.state_dict(),
                                           device="cpu")
    mask = np.random.RandomState(5).rand(len(x)) < 0.3
    for rescore in (True, False):
        _assert_same_hits(peng.search(q, K, rescore=rescore),
                          jeng.search(q, K, rescore=rescore))
        _assert_same_hits(peng.search(q, K, mask=mask, rescore=rescore),
                          jeng.search(q, K, mask=mask, rescore=rescore))


class TestOwnBuild:
    @pytest.mark.parametrize("quant", ["pq", "bq"])
    def test_recall_near_jax(self, quant):
        """The port trains its own quantizer (another generator) and builds
        its own graph; recall@10 with the exact rescore over 200 queries is
        within 0.05 of the JAX engine's own build on the same data (both
        read 0.63-0.76 here; the two differ by at most 0.022 over seeds
        0-2)."""
        x = _data()[0][:N]
        q = gaussian_mixture(200, DIM, n_clusters=15, scale=0.3, seed=2)
        jcfg, pcfg = _configs(quant)
        gt = exact_knn(q, x, K, "cosine")
        recall = []
        for eng in (JEngine(jcfg), QuantixarEngine(pcfg, device="cpu")):
            eng.add(x)
            eng.build()
            assert eng.quantizer_trains == 1 and eng.index_builds == 1
            recall.append(recall_at_k(eng.search(q, K)[1], gt))
        assert recall[1] >= recall[0] - 0.05, recall

    def test_delta_encodes_then_seal_reuses_codebooks(self):
        x, _, _ = _data()
        _, pcfg = _configs("pq")
        eng = QuantixarEngine(pcfg, device="cpu")
        eng.add(x[:N])
        eng.build()
        books = eng._pq.codebooks.clone()
        eng.add(x[N:])
        assert eng.delta_rows == N_DELTA and eng.quantizer_trains == 1
        assert eng._codes.shape == (N + N_DELTA, 6)
        assert (eng.search(x[N:], 1)[1][:, 0] == N + np.arange(N_DELTA)).all()
        assert eng.seal()
        assert eng.quantizer_trains == 1 and eng.seals == 1
        assert torch.equal(eng._pq.codebooks, books)
        assert (eng.search(x[N:], 1)[1][:, 0] == N + np.arange(N_DELTA)).all()

    def test_search_goes_through_the_code_domain(self, monkeypatch):
        """Layer 0 of a PQ search evaluates ADC on the codes (the plain
        version on the CPU), never the reconstruction rows."""
        x, q, _ = _data()
        _, pcfg = _configs("pq")
        eng = QuantixarEngine(pcfg, device="cpu")
        eng.add(x[:N])
        eng.build()
        calls = []
        from repro_torch.kernels import ops, ref
        real = ref.beam_gather_adc_ref

        def spy(*a):
            calls.append(a[1].shape)
            return real(*a)
        monkeypatch.setattr(ref, "beam_gather_adc_ref", spy)
        monkeypatch.setattr(ops.ref, "beam_gather_adc_ref", spy)
        before = bga_mod.launches
        eng.search(q, K)
        assert calls and bga_mod.launches == before
