"""The port's QuantixarEngine against the JAX engine.

A JAX engine's state_dict (sealed bulk-built graph + delta rows + metadata)
loads into the port's engine, which then returns the JAX engine's hits —
plain, under a ~50 % mask (HNSW), under a ~5 % mask (the flat route), and for
delta rows — at widths {1, 4}; the port's state_dict loads back into the
JAX engine with the same hits.  Also the port's own end-to-end path on the
CPU, the flat index, the device rule and IVF construction and state
loading (the IVF parity tests are tests/test_torch_ivf.py).
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import HNSWConfig as JHNSWConfig
from repro.core import Predicate as JPredicate
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import QuantixarEngine as JEngine
from repro.data.synthetic import gaussian_mixture
from repro_torch.core import EngineConfig, HNSWConfig, PQConfig, Predicate
from repro_torch.core import QuantixarEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, N_DELTA, DIM, K = 1500, 40, 24, 10
CASES = ("plain", "mask50", "mask5", "delta")


def _configs(metric, index="hnsw"):
    kw = dict(dim=DIM, metric=metric, index=index, builder="bulk")
    return (JEngineConfig(hnsw=JHNSWConfig(M=10, seed=0), **kw),
            EngineConfig(hnsw=HNSWConfig(M=10, seed=0), **kw))


def _data():
    x = gaussian_mixture(N + N_DELTA, DIM, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(16, DIM, n_clusters=15, scale=0.3, seed=2)
    meta = [{"tag": int(i % 20)} for i in range(N + N_DELTA)]
    return x, q, meta


@pytest.fixture(scope="module", params=["cosine", "l2"])
def engines(request):
    """(JAX engine, port engine loaded from its state_dict)."""
    x, q, meta = _data()
    jcfg, pcfg = _configs(request.param)
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
    @pytest.mark.parametrize("case", CASES)
    def test_hits_match_jax(self, engines, case, width):
        jeng, peng, x, q = engines
        queries, kw = _search_args(case, x, q)
        want = jeng.search(queries, K, expansion_width=width, **kw)
        got = peng.search(queries, K, expansion_width=width, **kw)
        _assert_same_hits(got, want)
        if case == "delta":
            assert (got[1][:, 0] == N + np.arange(12)).all()
        if case.startswith("mask"):
            ok = got[1] >= 0
            assert kw["mask"][got[1][ok]].all()

    def test_filter_matches_jax(self, engines):
        jeng, peng, _, q = engines
        want = jeng.search(q, K, flt=JPredicate("tag", "lt", 4))
        got = peng.search(q, K, flt=Predicate("tag", "lt", 4))
        _assert_same_hits(got, want)

    def test_state_dict_round_trips_into_jax(self, engines):
        jeng, peng, x, q = engines
        state = peng.state_dict()
        assert sorted(state) == sorted(jeng.state_dict())
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
                    "max_level", "n_upper"):
            assert ps[key] == js[key]
        assert ps["device"] == "cpu"


class TestEndToEnd:
    def test_build_matches_jax_engine(self):
        """The port's own add -> build (bulk) -> search equals the JAX
        engine's at a size whose build draws no k-means centroids."""
        x, q, meta = _data()
        jcfg, pcfg = _configs("cosine")
        jeng, peng = JEngine(jcfg), QuantixarEngine(pcfg, device="cpu")
        for e in (jeng, peng):
            e.add(x[:N], meta[:N])
            e.build()
        _assert_same_hits(peng.search(q, K), jeng.search(q, K))
        assert peng.stats()["builder_mode"] == "coarse"
        assert peng.index_builds == 1

    def test_delta_then_seal(self):
        x, q, _ = _data()
        _, pcfg = _configs("l2")
        eng = QuantixarEngine(pcfg, device="cpu")
        eng.add(x[:N])
        eng.build()
        eng.add(x[N:])
        assert eng.delta_rows == N_DELTA and eng.index_builds == 1
        assert (eng.search(x[N:], 1)[1][:, 0] == N + np.arange(N_DELTA)).all()
        assert eng.seal()
        assert eng.delta_rows == 0 and eng.seals == 1 and eng.index_builds == 2
        assert (eng.search(x[N:], 1)[1][:, 0] == N + np.arange(N_DELTA)).all()

    def test_flat_index_matches_jax(self):
        x, q, _ = _data()
        jcfg, pcfg = _configs("cosine", index="flat")
        jeng, peng = JEngine(jcfg), QuantixarEngine(pcfg, device="cpu")
        for e in (jeng, peng):
            e.add(x)
        mask = np.random.RandomState(5).rand(len(x)) < 0.3
        _assert_same_hits(peng.search(q, K), jeng.search(q, K))
        _assert_same_hits(peng.search(q, K, mask=mask),
                          jeng.search(q, K, mask=mask))

    def test_unit_corpus_cache(self):
        """The unit rows the cosine flat pass scans on the card: the corpus
        normalized once, cached until the next add(), and scanned with
        unit_corpus=True they give the flat index's hits bit for bit."""
        from repro_torch.core.distances import normalize
        from repro_torch.core.flat import flat_search
        x, q, _ = _data()
        _, pcfg = _configs("cosine", index="flat")
        eng = QuantixarEngine(pcfg, device="cpu")
        eng.add(x[:N])
        unit = eng._unit_corpus_device()
        assert torch.equal(unit, normalize(torch.as_tensor(x[:N])))
        assert eng._unit_corpus_device() is unit
        d, i = flat_search(torch.as_tensor(q), unit, K, metric="cosine",
                           unit_corpus=True)
        wd, wi = eng.search(q, K)
        np.testing.assert_array_equal(i.numpy(), wi)
        np.testing.assert_array_equal(d.numpy(), wd)
        eng.add(x[N:])
        assert eng._unit_corpus_device().shape[0] == N + N_DELTA


class TestConfig:
    def test_entry_points_need_cuda_unless_told_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, pcfg = _configs("cosine")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QuantixarEngine(pcfg)
        from repro_torch.core import bulk_build_device, to_device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bulk_build_device(np.zeros((40, 4), np.float32))
        eng = QuantixarEngine(pcfg, device="cpu")
        assert eng.device.type == "cpu"
        with pytest.raises(RuntimeError):
            to_device(None, "cuda")

    @pytest.mark.parametrize("kw,item", [
        (dict(quantization="pq", index="ivf"), "A8"),
        (dict(quantization="bq", index="ivf"), "A8"),
        (dict(index="ivf"), "A8")])
    def test_unported_options_raise(self, kw, item):
        """IVF (ROADMAP A8), the last option that raised, now constructs
        and builds, with or without codes: the config follows the JAX
        engine's IVF metric rule, and a tiny engine on the CPU answers with
        its own rows (tests/test_torch_ivf.py holds it to the JAX hits).
        The name and ``item`` (each case's ROADMAP item, the message of
        its config check) are those it had while these options raised,
        kept so that runs before and after the port compare test by
        test."""
        from repro.core import bq as jbq
        from repro.core import pq as jpq
        from repro_torch.core import BQConfig
        for metric in ("cosine", "l2", "dot"):
            cfg = EngineConfig(dim=8, metric=metric, **kw)
            assert cfg.index == "ivf"
            want = JEngineConfig(dim=8, metric=metric, **kw).ivf
            assert dataclasses.asdict(cfg.ivf) == dataclasses.asdict(want), \
                item
        x = gaussian_mixture(300, 8, n_clusters=4, scale=0.3, seed=1)
        cfg = EngineConfig(dim=8, pq=PQConfig(m=2, k=16, iters=4),
                           bq=BQConfig(bits=32), **kw)
        eng = QuantixarEngine(cfg, device="cpu")
        eng.add(x)
        _, ids = eng.search(x[:5], 3, rescore=True)
        assert (ids[:, 0] == np.arange(5)).all()
        assert eng.stats()["ivf_lists"] == cfg.ivf.nlist
        jcfg = JEngineConfig(dim=8, pq=jpq.PQConfig(m=2, k=16, iters=4),
                             bq=jbq.BQConfig(bits=32), **kw)
        assert QuantixarEngine.from_state_dict(
            cfg, eng.state_dict(), device="cpu").stats()["ivf_max_list"] \
            == JEngine.from_state_dict(
                jcfg, eng.state_dict()).stats()["ivf_max_list"]

    def test_quantized_state_raises(self):
        """A state with IVF lists (a JAX engine's) now loads and answers as
        the JAX engine does; one with PQ codebooks and codes (the JAX
        layout) loads as before.  Named for the raise it held before IVF
        states loaded, kept so that runs before and after the port compare
        test by test."""
        x = gaussian_mixture(300, 8, n_clusters=4, scale=0.3, seed=1)
        jeng = JEngine(JEngineConfig(dim=8, index="ivf"))
        jeng.add(x)
        jeng.build()
        state = jeng.state_dict()
        assert any(k.startswith("ivf.") for k in state)
        eng = QuantixarEngine.from_state_dict(EngineConfig(dim=8, index="ivf"),
                                              state, device="cpu")
        got, want = eng.search(x[:6], 4), jeng.search(x[:6], 4)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        state = {"vectors": np.zeros((2, 8), np.float32), "n": np.array([2]),
                 "dirty": np.array([True]), "meta.__n__": np.array([2]),
                 "codes": np.zeros((2, 2), np.uint8),
                 "pq.codebooks": np.zeros((2, 4, 4), np.float32)}
        eng = QuantixarEngine.from_state_dict(
            EngineConfig(dim=8, quantization="pq", pq=PQConfig(m=2, k=4)),
            state, device="cpu")
        assert eng._pq.codebooks.shape == (2, 4, 4)
        assert eng._codes.dtype == np.uint8

    def test_tf32_off(self):
        import repro_torch.core.engine  # noqa: F401
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False


class TestChipSmoke:
    def test_fails_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: chip_smoke.py would run")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

    def test_fails_alone(self, tmp_path):
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
