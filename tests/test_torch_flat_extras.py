"""The flat leftovers of the port's core against ``repro.core``:
``FlatIndex``, ``brute_force_topk``, the single-pair metrics and the
package's exports.

Integer-valued inputs make every distance exact in fp32, so the ids must
match exactly, ties included; Gaussian inputs are compared at rtol 1e-5 /
atol 1e-5 (the products add in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as pcore
from repro.core import distances as jdist
from repro_torch.core import distances as pdist

TOL = dict(rtol=1e-5, atol=1e-5)


def _ints(seed, n, d):
    return np.random.RandomState(seed).randint(-3, 4, (n, d)).astype(
        np.float32)


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("k", [1, 7, 40])
def test_brute_force_topk_ties(metric, k):
    x, q = _ints(0, 40, 6), _ints(1, 5, 6)
    if metric == "cosine":
        # unit rows of small integer vectors: a few exact values, many ties
        x[x.sum(1) == 0] = 1.0
    jd, ji = jdist.brute_force_topk(jnp.asarray(q), jnp.asarray(x), k, metric)
    d, i = pcore.brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), k,
                                  metric)
    assert i.dtype == torch.int32 and d.dtype == torch.float32
    if metric == "cosine":
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    else:
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_brute_force_topk_gaussian(metric):
    rng = np.random.RandomState(2)
    x = rng.randn(300, 16).astype(np.float32)
    q = rng.randn(9, 16).astype(np.float32)
    jd, ji = jdist.brute_force_topk(jnp.asarray(q), jnp.asarray(x), 10, metric)
    d, i = pcore.brute_force_topk(torch.from_numpy(q), torch.from_numpy(x),
                                  10, metric)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_brute_force_topk_hamming():
    rng = np.random.RandomState(3)
    words = rng.randint(0, 2 ** 32, (50, 3), dtype=np.uint64).astype(np.uint32)
    qw = rng.randint(0, 2 ** 32, (4, 3), dtype=np.uint64).astype(np.uint32)
    jd, ji = jdist.brute_force_topk(jnp.asarray(qw), jnp.asarray(words), 12,
                                    "hamming")
    d, i = pcore.brute_force_topk(torch.from_numpy(qw.view(np.int32)),
                                  torch.from_numpy(words.view(np.int32)), 12,
                                  "hamming")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("chunk", [None, 16, 200])
@pytest.mark.parametrize("masked", [False, True])
def test_flat_index(metric, chunk, masked):
    x, q = _ints(4, 90, 8), _ints(5, 6, 8)
    x[x.sum(1) == 0] = 1.0
    mask = np.random.RandomState(6).rand(90) < 0.4 if masked else None
    jidx = jcore.FlatIndex(metric=metric, chunk=chunk)
    pidx = pcore.FlatIndex(metric=metric, chunk=chunk)
    assert (pidx.metric, pidx.chunk) == (jidx.metric, jidx.chunk)
    jd, ji = jidx.search(jnp.asarray(x), jnp.asarray(q), 10,
                         mask=None if mask is None else jnp.asarray(mask))
    d, i = pidx.search(torch.from_numpy(x), torch.from_numpy(q), 10,
                       mask=None if mask is None else torch.from_numpy(mask))
    assert i.dtype == torch.int32
    if metric == "cosine":
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    else:
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_flat_index_default_is_cosine():
    assert pcore.FlatIndex().metric == jcore.FlatIndex().metric == "cosine"
    assert pcore.FlatIndex().chunk is None


@pytest.mark.parametrize("name", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("shape", [(16,), (5, 16), (3, 4, 16)])
def test_point_metrics(name, shape):
    rng = np.random.RandomState(7)
    q = rng.randn(*shape).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    got = pdist.POINT_METRICS[name](torch.from_numpy(q), torch.from_numpy(x))
    want = jdist.POINT_METRICS[name](jnp.asarray(q), jnp.asarray(x))
    assert got.shape == tuple(np.asarray(want).shape)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert pdist.POINT_METRICS[name] is getattr(pdist, f"point_{name}")


def test_point_metrics_registry():
    assert set(pdist.POINT_METRICS) == set(jdist.POINT_METRICS)


def test_core_exports_cover_the_jax_packages():
    assert set(jcore.__all__) <= set(pcore.__all__)
    for name in pcore.__all__:
        assert hasattr(pcore, name), name
