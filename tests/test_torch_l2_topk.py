"""B5's fused top-k entry (``l2_topk``) on the CPU: its plain version against
the JAX package, the key decoding, the wrapper's contract, and the exact
scan (``flat_search``) that runs it on the card, unchanged on the CPU.

The plain version is ``topk_smallest`` over the plain distances with masked
rows at +inf.  The JAX side is the interpret-mode Pallas
``l2_distance_kernel`` followed by ``lax.top_k(-d, k)`` (ties to the lowest
index, -0.0 below +0.0).  Inputs are small integers, so every distance is
exact in fp32 in any summation order: indices must agree exactly, and the
many ties test the tie order.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2 import l2_distance_kernel
from repro_torch.core.distances import normalize
from repro_torch.core.flat import flat_search, scan_topk
from repro_torch.kernels import l2 as l2_mod
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)


def _tied_inputs(seed, nq, n, d):
    """Integer vectors with duplicate corpus rows and zero vectors: exact
    fp32 distances, many ties, and -0.0 in dot mode (q . 0 = 0)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-2, 3, (n, d)).astype(np.float32)
    q = rng.randint(-2, 3, (nq, d)).astype(np.float32)
    x[1::7] = x[0]                         # duplicate rows: tied distances
    x[3::11] = 0.0                         # zero rows: dot = -0.0
    q[0] = 0.0                             # a zero query: every dot -0.0
    return q, x


def _jax_topk(q, x, k, mode, mask):
    """The JAX package's composition: Pallas distances, masked, lax.top_k."""
    kmode = "l2" if mode == "l2" else "dot"
    d = l2_distance_kernel(jnp.asarray(q), jnp.asarray(x), mode=kmode, tq=16,
                           tn=128, tk=64, interpret=True)
    if mode == "cosine":
        d = 1.0 + d
    if mask is not None:
        d = jnp.where(jnp.asarray(mask)[None, :], d, jnp.inf)
    neg, idx = jax.lax.top_k(-d, k)
    return -np.asarray(neg), np.asarray(idx)


@pytest.mark.parametrize("k", [1, 10, 40, 256])
@pytest.mark.parametrize("mode", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_jax(k, mode, masked):
    q, x = _tied_inputs(k, 9, 300, 16)
    mask = None
    if masked:
        # fewer live rows than k at k = 256: masked rows come back at +inf,
        # lowest column first
        mask = np.random.RandomState(1).rand(300) < 0.5
    before = (l2_mod.launches, l2_mod.topk_launches)
    d, i = ops.l2_topk(torch.as_tensor(q), torch.as_tensor(x), k, mode=mode,
                       mask=None if mask is None else torch.as_tensor(mask))
    assert (l2_mod.launches, l2_mod.topk_launches) == before   # no launch
    assert d.shape == i.shape == (9, k)
    assert d.dtype == torch.float32 and i.dtype == torch.int64
    jd, ji = _jax_topk(q, x, k, mode, mask)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, **TOL)
    if mode == "dot":
        # the zero query: every live distance is -0.0, in column order
        d0 = d[0].numpy()
        live = np.isfinite(d0)
        assert (d0[live] == 0).all() and np.signbit(d0[live]).all()
        assert (np.diff(i[0].numpy()[live]) > 0).all()
    if masked and k == 256:
        assert np.isinf(d.numpy()).any()


def test_plain_is_topk_smallest_of_the_matrix():
    """The plain version is exactly topk_smallest over the plain matrix,
    masked at +inf: the contract the card's fused entry is held to."""
    q, x = _tied_inputs(5, 7, 200, 12)
    qt, xt = torch.as_tensor(q), torch.as_tensor(x)
    mask = torch.as_tensor(np.random.RandomState(2).rand(200) < 0.3)
    for mode, plain in (("l2", ref.l2_distance_ref),
                        ("dot", ref.dot_distance_ref)):
        full = plain(qt, xt).masked_fill(~mask[None], float("inf"))
        wd, wi = ref.topk_smallest(full, 30)
        d, i = ops.l2_topk(qt, xt, 30, mode=mode, mask=mask)
        assert torch.equal(i, wi)
        assert torch.equal(d.view(torch.int32), wd.view(torch.int32))


def test_decode_keys_inverts_the_key():
    """decode_keys recovers every float's bits (signed zeros, infinities,
    NaN) and the column from topk_smallest's 64-bit key."""
    vals = torch.tensor([0.0, -0.0, 1.5, -1.5, float("inf"), float("-inf"),
                         float("nan"), 3e-39, -3e-39, 2.0 ** 100])
    bits = vals.view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    cols = torch.arange(len(vals), dtype=torch.int64) * 977 + 12345
    d, c = l2_mod.decode_keys((ordered << 32) | cols)
    assert torch.equal(d.view(torch.int32), bits)
    assert torch.equal(c, cols)


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        l2_mod.l2_topk(x, x, 2)
    with pytest.raises(ValueError, match="mode"):
        l2_mod.l2_topk(x, x, 2, mode="hamming")


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("chunk", [None, 64])
def test_cpu_flat_search_is_the_plain_composition(metric, chunk):
    """On the CPU flat_search is unchanged: the (chunked) scan over the
    metric registry, equal to the fused entry's plain version over the
    whole corpus in one block, ties and masks included."""
    q, x = _tied_inputs(3, 6, 250, 16)
    qt, xt = torch.as_tensor(q), torch.as_tensor(x)
    mask = torch.as_tensor(np.random.RandomState(4).rand(250) < 0.6)
    d, i = flat_search(qt, xt, 12, metric=metric, chunk=chunk, mask=mask,
                       base_index=1000)
    assert i.dtype == torch.int32
    if metric == "cosine":
        qt, xt = normalize(qt), normalize(xt)
    wd, wi = ops.l2_topk(qt, xt, 12, mode=metric, mask=mask)
    assert torch.equal(i.long(), wi + 1000)
    if chunk is None:
        assert torch.equal(d.view(torch.int32), wd.view(torch.int32))
    else:
        torch.testing.assert_close(d, wd, **TOL)


def test_cpu_flat_search_past_the_fused_k():
    """k above the fused entry's 256 keeps the chunked scan (the only
    route on the CPU): the same answer as one topk_smallest."""
    q, x = _tied_inputs(6, 3, 400, 8)
    qt, xt = torch.as_tensor(q), torch.as_tensor(x)
    d, i = flat_search(qt, xt, 300, metric="l2", chunk=128)
    wd, wi = scan_topk(lambda lo, hi: ref.l2_distance_ref(qt, xt[lo:hi]),
                       400, 300)
    assert torch.equal(i, wi) and torch.equal(d, wd)
    assert l2_mod.MAX_K == 256


@pytest.mark.parametrize("k", [12, 300])
@pytest.mark.parametrize("chunk", [None, 64])
def test_cpu_flat_search_on_unit_rows(k, chunk):
    """unit_corpus=True (the engine's cached unit rows, cosine) is the same
    scan as the raw corpus normalized in the call, bit for bit: normalize
    works row by row, whether over the whole corpus or one chunk."""
    q, x = _tied_inputs(9, 5, 400, 16)
    qt, xt = torch.as_tensor(q), torch.as_tensor(x)
    mask = torch.as_tensor(np.random.RandomState(2).rand(400) < 0.8)
    d, i = flat_search(qt, normalize(xt), k, metric="cosine", chunk=chunk,
                       mask=mask, unit_corpus=True)
    wd, wi = flat_search(qt, xt, k, metric="cosine", chunk=chunk, mask=mask)
    assert torch.equal(i, wi)
    assert torch.equal(d.view(torch.int32), wd.view(torch.int32))


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("chunk", [None, 16, 50, 64])
@pytest.mark.parametrize("live", [0, 3, 30])
def test_cpu_flat_search_empty_slots_match_jax(metric, chunk, live):
    """A mask that leaves fewer than k rows: the chunked scan (chunk < N)
    returns the reference's -1 in the +inf slots, base_index not added;
    unchunked (None, or chunk >= N = 50) the masked rows' ids, as the
    reference's own unchunked scan does.  Finite slots agree exactly."""
    from repro.core.flat import flat_search as jax_flat_search
    rng = np.random.RandomState(live)
    x = rng.randn(50, 8).astype(np.float32)
    q = rng.randn(4, 8).astype(np.float32)
    mask = np.zeros(50, dtype=bool)
    mask[rng.permutation(50)[:live]] = True
    k = 5
    wd, wi = jax_flat_search(jnp.asarray(q), jnp.asarray(x), k,
                             metric=metric, chunk=chunk,
                             mask=jnp.asarray(mask), base_index=100)
    wd, wi = np.asarray(wd), np.asarray(wi)
    d, i = flat_search(torch.as_tensor(q), torch.as_tensor(x), k,
                       metric=metric, chunk=chunk,
                       mask=torch.as_tensor(mask), base_index=100)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_allclose(d.numpy(), wd, **TOL)
    empty = np.isinf(wd)
    assert empty.sum() == 4 * max(k - live, 0)
    if chunk is not None and chunk < 50:
        assert (wi[empty] == -1).all()
