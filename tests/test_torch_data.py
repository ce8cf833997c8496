"""The port's data package against the JAX package's ``repro.data``: the
host pipeline (``host_slice``, ``Prefetcher``, ``device_put_batches`` on
the CPU) and the synthetic corpora (``make_corpus``)."""

import time

import jax
import numpy as np
import pytest
import torch

from torch.utils import _pytree as pytree

import repro.data as jdata
import repro_torch.data as pdata


class TestPipeline:
    def test_host_slice_partitions(self):
        slices = [pdata.host_slice(64, 4, h) for h in range(4)]
        rows = np.concatenate([np.arange(64)[s] for s in slices])
        np.testing.assert_array_equal(np.sort(rows), np.arange(64))
        assert slices == [jdata.host_slice(64, 4, h) for h in range(4)]
        with pytest.raises(ValueError):
            pdata.host_slice(10, 3, 0)

    def test_prefetcher_order_and_errors(self):
        assert list(pdata.Prefetcher(iter(range(10)), depth=3)) \
            == list(range(10))

        def boom():
            yield 1
            raise RuntimeError("io error")

        pf = pdata.Prefetcher(boom())
        assert next(pf) == 1
        with pytest.raises(RuntimeError):
            next(pf)
            next(pf)

    def test_prefetcher_stays_within_depth(self):
        """The producer runs at most ``depth`` items (plus the one it holds)
        ahead of the consumer."""
        made = []

        def items():
            for i in range(10):
                made.append(i)
                yield i

        pf = pdata.Prefetcher(items(), depth=2)
        time.sleep(0.3)
        assert len(made) <= 3
        assert list(pf) == list(range(10))

    @pytest.mark.parametrize("make", [
        lambda r: {"x": r.randn(4, 3).astype(np.float32),
                   "ids": r.randint(0, 9, (4,)).astype(np.int32)},
        lambda r: (r.randn(2, 5).astype(np.float32),
                   r.randint(0, 2 ** 31, (2,)).astype(np.int64)),
        lambda r: [r.randn(3).astype(np.float64),
                   {"m": (r.rand(2, 2) > 0.5)}],
        lambda r: r.randn(6, 2).astype(np.float32),
    ], ids=["dict", "tuple", "list_nested", "array"])
    def test_device_put_batches_on_the_cpu(self, make):
        """The batches' containers in order, each leaf a CPU tensor with
        the array's dtype and the values the JAX package's
        ``device_put_batches`` puts (which narrows 64-bit types to 32)."""
        batches = [make(np.random.RandomState(s)) for s in range(5)]
        got = list(pdata.device_put_batches(iter(batches), device="cpu",
                                            depth=2))
        want = list(jdata.device_put_batches(iter(batches), depth=2))
        assert len(got) == len(want) == 5
        for g, w, b in zip(got, want, batches):
            assert pytree.tree_structure(g) == pytree.tree_structure(b)
            # leaves in one order (JAX's sorts dict keys)
            leaves = [jax.tree_util.tree_leaves(t) for t in (g, b, w)]
            assert len({len(x) for x in leaves}) == 1
            for gl, bl, wl in zip(*leaves):
                wl = np.asarray(wl)
                assert isinstance(gl, torch.Tensor) and gl.device.type == "cpu"
                assert gl.numpy().dtype == bl.dtype
                np.testing.assert_array_equal(gl.numpy(), bl)
                np.testing.assert_array_equal(gl.numpy().astype(wl.dtype), wl)

    def test_device_put_batches_surfaces_errors(self):
        def boom():
            yield np.zeros(3)
            raise RuntimeError("io error")

        it = pdata.device_put_batches(boom(), device="cpu")
        assert torch.equal(next(it), torch.zeros(3, dtype=torch.float64))
        with pytest.raises(RuntimeError, match="io error"):
            next(it)

    def test_device_put_batches_on_the_card_needs_one(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pdata.device_put_batches(iter([np.zeros(2)]))


@pytest.mark.parametrize("spec", ["SIFT", "FASHION_MNIST", "gauss"])
def test_make_corpus_is_the_jax_packages(spec):
    if spec == "gauss":
        jspec = jdata.DatasetSpec("glove-like", 24, "cosine")
        pspec = pdata.DatasetSpec("glove-like", 24, "cosine")
    else:
        jspec, pspec = getattr(jdata, spec), getattr(pdata, spec)
    for seed in (0, 3):
        got = pdata.make_corpus(pspec, 300, seed=seed)
        want = jdata.make_corpus(jspec, 300, seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_exports_match():
    public = {n for n in dir(jdata) if not n.startswith("_")}
    assert "device_put_batches" in public and "make_corpus" in public
    assert public <= {n for n in dir(pdata) if not n.startswith("_")}
