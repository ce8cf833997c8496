"""The port's kernel layer against the JAX package.

Each plain PyTorch version (what a CPU tensor runs) is held to the JAX
package's oracle in ``repro.kernels.ref`` and to its Pallas kernel in
interpret mode, on the same numpy inputs, at the tolerance the JAX package's
own kernel tests use (tests/test_kernels.py: rtol = atol = 2e-4).  Also: the
dispatch contract (CPU -> plain, CUDA -> kernel or raise, launch counters),
the build helper, the tie-stable top-k, and that the port imports without
JAX.  The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.beam_gather import beam_gather_kernel
from repro.kernels.bulk_prune import pair_gather_kernel
from repro.kernels.l2 import l2_distance_kernel
from repro_torch.core.flat import flat_search, merge_topk, topk_smallest
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import beam_gather as bg_mod
from repro_torch.kernels import bulk_prune as pg_mod
from repro_torch.kernels import l2 as l2_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)


def _beam_inputs(seed, nq, n, d, length, repeat=False):
    rng = np.random.RandomState(seed)
    corpus = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
    ids = rng.randint(0, n, (nq, length)).astype(np.int32)
    if repeat:                       # repeated rows and both corpus ends
        ids[:, ::3] = ids[:, :1]
        ids[:, 1::4] = 0
        ids[:, 2::5] = n - 1
    return corpus, q, ids


class TestBeamGatherPlain:
    @pytest.mark.parametrize("n,d,length,repeat", [
        (200, 16, 1, False),     # the entry-point call (L = 1)
        (200, 16, 37, True),     # ragged L, repeated ids
        (300, 128, 128, False),  # the search block at width 4, M0 = 32
        (97, 128, 65, True),
    ])
    @pytest.mark.parametrize("mode", ["l2", "dot"])
    def test_matches_jax_ref_and_pallas(self, n, d, length, repeat, mode):
        corpus, q, ids = _beam_inputs(n + length, 2, n, d, length, repeat)
        plain = ref.beam_gather_l2_ref if mode == "l2" \
            else ref.beam_gather_dot_ref
        got = plain(torch.as_tensor(q), torch.as_tensor(ids),
                    torch.as_tensor(corpus)).numpy()
        jplain = jref.beam_gather_l2_ref if mode == "l2" \
            else jref.beam_gather_dot_ref
        for i in range(len(q)):
            want = jplain(jnp.asarray(q[i]), jnp.asarray(ids[i]),
                          jnp.asarray(corpus))
            np.testing.assert_allclose(got[i], np.asarray(want), **TOL)
            pallas = beam_gather_kernel(jnp.asarray(q[i]), jnp.asarray(ids[i]),
                                        jnp.asarray(corpus), mode=mode,
                                        tb=min(32, length), interpret=True)
            np.testing.assert_allclose(got[i], np.asarray(pallas), **TOL)


class TestPairGatherPlain:
    @pytest.mark.parametrize("n,d,c,repeat", [
        (50, 16, 1, False),      # single candidate
        (100, 16, 19, True),     # ragged C, repeated ids
        (300, 128, 60, False),   # the coarse prune's C
        (120, 128, 33, True),
    ])
    @pytest.mark.parametrize("mode", ["l2", "dot"])
    def test_matches_jax_ref_and_pallas(self, n, d, c, repeat, mode):
        corpus, _, ids = _beam_inputs(n + c, 2, n, d, c, repeat)
        plain = ref.pair_gather_l2_ref if mode == "l2" \
            else ref.pair_gather_dot_ref
        got = plain(torch.as_tensor(ids), torch.as_tensor(corpus)).numpy()
        jplain = jref.pair_gather_l2_ref if mode == "l2" \
            else jref.pair_gather_dot_ref
        for i in range(len(ids)):
            want = jplain(jnp.asarray(ids[i]), jnp.asarray(corpus))
            # norm-expansion L2 cancels: scale atol by the row norms, as
            # for the Pallas kernel on the same inputs
            np.testing.assert_allclose(got[i], np.asarray(want), rtol=2e-4,
                                       atol=2e-4 * d)
            pallas = pair_gather_kernel(jnp.asarray(ids[i]),
                                        jnp.asarray(corpus), mode=mode,
                                        interpret=True)
            np.testing.assert_allclose(got[i], np.asarray(pallas), rtol=2e-4,
                                       atol=2e-4 * d)


class TestL2DistancePlain:
    """B5's plain version against the JAX oracle and the interpret-mode
    Pallas kernel, at the shapes of the JAX package's own kernel test."""

    @pytest.mark.parametrize("q,n,d,mode", [
        (8, 128, 64, "l2"),       # tile-aligned
        (7, 300, 130, "l2"),      # padding on every axis
        (64, 1024, 784, "l2"),    # fashion-mnist dims
        (1, 33, 128, "l2"),       # single query, sift dims
        (3, 50, 16, "l2"),        # tiny
        (9, 200, 96, "dot"),
        (16, 128, 128, "dot"),
    ])
    def test_matches_jax_ref_and_pallas(self, q, n, d, mode):
        rng = np.random.RandomState(q * n + d)
        qs = rng.randn(q, d).astype(np.float32)
        xs = rng.randn(n, d).astype(np.float32)
        plain = ops.l2_distances if mode == "l2" else ops.dot_distances
        jref_fn = (jref.l2_distance_ref if mode == "l2"
                   else jref.dot_distance_ref)
        before = l2_mod.launches
        got = plain(torch.as_tensor(qs), torch.as_tensor(xs)).numpy()
        assert l2_mod.launches == before       # the plain version: no launch
        assert got.shape == (q, n) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(jref_fn(qs, xs)), **TOL)
        pallas = l2_distance_kernel(jnp.asarray(qs), jnp.asarray(xs),
                                    mode=mode, tq=16, tn=128, tk=64,
                                    interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
        if mode == "l2":
            assert (got >= 0).all()

    def test_metric_registry_runs_it(self):
        """pairwise l2 / dot / cosine are B5 (cosine in dot mode on unit
        rows) and hamming is B7, equal to the JAX package's metrics."""
        from repro.core import distances as jd
        from repro_torch.core import distances as td
        rng = np.random.RandomState(7)
        qs = rng.randn(5, 24).astype(np.float32)
        xs = rng.randn(40, 24).astype(np.float32)
        assert td.available_metrics() == jd.available_metrics()
        for metric in ("l2", "dot", "cosine"):
            got = td.get_metric(metric)(torch.as_tensor(qs),
                                        torch.as_tensor(xs))
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jd.get_metric(metric)(qs, xs)),
                **TOL)
        words = rng.randint(0, 2 ** 32, (40, 3), dtype=np.uint64)
        got = td.get_metric("hamming")(
            torch.as_tensor(words[:5].astype(np.uint32).view(np.int32)),
            torch.as_tensor(words.astype(np.uint32).view(np.int32)))
        want = jd.pairwise_hamming(jnp.asarray(words[:5].astype(np.uint32)),
                                   jnp.asarray(words.astype(np.uint32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_wrapper_refuses_cpu_tensors_and_bad_modes(self):
        x = torch.zeros(4, 8)
        with pytest.raises(ValueError, match="CUDA tensor"):
            l2_mod.l2_distance(x, x)
        with pytest.raises(ValueError, match="mode"):
            l2_mod.l2_distance(x, x, mode="cosine")


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        corpus, q, ids = _beam_inputs(0, 3, 40, 8, 5)
        before = (bg_mod.launches, pg_mod.launches)
        for mode in ("l2", "dot"):
            got = ops.beam_gather_distances(torch.as_tensor(q),
                                            torch.as_tensor(ids),
                                            torch.as_tensor(corpus), mode=mode)
            want = (ref.beam_gather_l2_ref if mode == "l2"
                    else ref.beam_gather_dot_ref)(
                torch.as_tensor(q), torch.as_tensor(ids),
                torch.as_tensor(corpus))
            assert torch.equal(got, want)
            pair = ops.pair_gather_distances(torch.as_tensor(ids),
                                             torch.as_tensor(corpus),
                                             mode=mode)
            assert pair.shape == (3, 5, 5)
        # the plain version is no launch
        assert (bg_mod.launches, pg_mod.launches) == before

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        corpus, q, ids = _beam_inputs(1, 2, 30, 8, 4)
        with pytest.raises(ValueError, match="CUDA tensor"):
            bg_mod.beam_gather(torch.as_tensor(q), torch.as_tensor(ids),
                               torch.as_tensor(corpus))
        with pytest.raises(ValueError, match="CUDA tensor"):
            pg_mod.pair_gather(torch.as_tensor(ids), torch.as_tensor(corpus))

    @pytest.mark.parametrize("force_ref", [False, True])
    def test_cpu_search_takes_the_plain_step(self, monkeypatch, force_ref):
        """On the CPU the float search's layer-0 loop takes B1ˢ's plain
        version: ``ops.beam_gather_step`` returns None without building or
        launching anything, and ``force_ref`` leaves the results as they
        are."""
        from repro_torch.core.hnsw_search import HNSWGraph, beam_state, search

        def no_build(name):
            raise AssertionError(f"{name} built on the CPU")

        monkeypatch.setattr(_build, "load", no_build)
        rng = np.random.RandomState(0)
        n, d, m0, ef = 300, 8, 6, 16
        vecs = torch.as_tensor(rng.randn(n, d).astype(np.float32))
        adj0 = torch.as_tensor(np.stack(
            [rng.choice(np.delete(np.arange(n), i), m0, replace=False)
             for i in range(n)]).astype(np.int32))
        g = HNSWGraph(vecs, adj0, torch.zeros(0, dtype=torch.int64),
                      torch.zeros((0, 0, 1), dtype=torch.int64), 0, 0)
        q = torch.as_tensor(rng.randn(5, d).astype(np.float32))
        state = beam_state(torch.zeros(5, dtype=torch.int64), ef, 4 * ef,
                           (n + 31) // 32, lambda ids, fresh: torch.where(
                               fresh, ops.beam_gather_distances(
                                   q, ids, vecs), float("inf")))
        assert ops.beam_gather_step(q, adj0, vecs, state, width=4,
                                    max_iters=4 * ef,
                                    force_ref=force_ref) is None
        before = bg_mod.step_launches
        got = search(g, q, k=5, ef=ef, max_level=0, metric="l2",
                     with_iters=True, force_ref=force_ref)
        want = search(g, q, k=5, ef=ef, max_level=0, metric="l2",
                      with_iters=True)
        assert bg_mod.step_launches == before
        assert int(got[2].max()) > 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    def test_no_environment_switch(self):
        src = open(os.path.join(ROOT, "src", "repro_torch", "kernels",
                                "ops.py")).read()
        assert "QUANTIXAR_REF" not in src and "os.environ" not in src
        assert "except" not in src


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(["beam_gather"])

    def test_library_keyed_on_source_hash(self, monkeypatch, tmp_path):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for name in _build.KERNELS:
            (csrc / f"{name}.cu").write_bytes(
                (_build.CSRC / f"{name}.cu").read_bytes())
        monkeypatch.setattr(_build, "CSRC", csrc)
        a = _build.library_path("beam_gather")
        assert a == _build.library_path("beam_gather")
        assert a.parent == _build.BUILD_DIR
        (csrc / "beam_gather.cu").write_text(
            (csrc / "beam_gather.cu").read_text() + "\n// edit\n")
        assert _build.library_path("beam_gather") != a
        assert _build.library_path("pair_gather").name.startswith(
            "libpair_gather-")

    def test_build_dir_is_ignored_by_git(self):
        ignore = open(os.path.join(ROOT, ".gitignore")).read().split()
        rel = os.path.relpath(_build.BUILD_DIR, ROOT).split(os.sep)[0]
        assert f"{rel}/" in ignore


class TestTieStableTopk:
    """lax.top_k breaks ties by lowest index; torch.topk does not."""

    @pytest.mark.parametrize("n,k", [(8, 4), (40, 10), (200, 64), (3, 3)])
    def test_matches_lax_top_k_on_ties(self, n, k):
        rng = np.random.RandomState(n)
        x = rng.randint(0, 4, (6, n)).astype(np.float32)
        x[0, ::2] = np.inf                   # masked slots tie at +inf
        x[1, :] = 0.0
        x[1, ::3] = -0.0                     # lax.top_k: -0.0 below +0.0
        x[2, :] = -np.inf
        neg, idx = jax.lax.top_k(-jnp.asarray(x), k)
        val, pos = topk_smallest(torch.as_tensor(x), k)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(val.numpy(), -np.asarray(neg))

    def test_wide_row(self):
        """The flat route's 1M-wide rows are selected, never sorted."""
        rng = np.random.RandomState(5)
        x = rng.randint(0, 50, (3, 200_000)).astype(np.float32)
        neg, idx = jax.lax.top_k(-jnp.asarray(x), 25)
        _, pos = topk_smallest(torch.as_tensor(x), 25)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(idx))

    def test_merge_and_chunked_flat_keep_lowest_index(self):
        from repro.core.flat import flat_search as jflat
        rng = np.random.RandomState(2)
        corpus = rng.randint(0, 3, (97, 4)).astype(np.float32)  # many ties
        q = rng.randint(0, 3, (5, 4)).astype(np.float32)
        mask = rng.rand(97) < 0.6
        jd, ji = jflat(jnp.asarray(q), jnp.asarray(corpus), 12, metric="l2",
                       mask=jnp.asarray(mask))
        for chunk in (None, 10, 97):
            d, i = flat_search(torch.as_tensor(q), torch.as_tensor(corpus), 12,
                               metric="l2", chunk=chunk,
                               mask=torch.as_tensor(mask))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
        a = torch.tensor([[1.0, 2.0]])
        d, i = merge_topk(a, torch.tensor([[5, 6]]), a, torch.tensor([[7, 8]]),
                          3)
        assert i.tolist() == [[5, 7, 6]]


def test_port_imports_without_jax():
    """Every repro_torch module imports with jax blocked, and none pulls in
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "for m in ('core.pq', 'core.bq', 'kernels.beam_gather_adc',\n"
        "          'kernels.beam_gather_hamming', 'kernels.pq_adc',\n"
        "          'kernels.hamming', 'kernels._launch', 'kernels.l2',\n"
        "          'core.sparse', 'core.ivf', 'api.database',\n"
        "          'serving.batcher', 'checkpoint.store', 'kernels.slstm',\n"
        "          'configs', 'configs.xlstm_1_3b', 'models.model',\n"
        "          'models.recurrent', 'models.convert', 'models.steps'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
