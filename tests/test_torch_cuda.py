"""The port's CUDA kernels and its default collection on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (a CUDA kernel has no
CPU mode).  This file imports no JAX, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, HNSWConfig, IVFConfig, IVFIndex,
                              QuantixarEngine, bulk_build_device)
from repro_torch.core.hnsw_build import preprocess_vectors
from repro_torch.core.hnsw_search import to_device
from repro_torch.core.flat import FUSED_MAX_K, flat_search, topk_smallest
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.kernels import beam_gather as bg_mod
from repro_torch.kernels import beam_gather_adc as bga_mod
from repro_torch.kernels import beam_gather_hamming as bgh_mod
from repro_torch.kernels import bulk_prune as pg_mod
from repro_torch.kernels import hamming as hm_mod
from repro_torch.kernels import l2 as l2_mod
from repro_torch.kernels import ops
from repro_torch.kernels import pq_adc as adc_mod
from repro_torch.kernels import ref
from repro_torch.kernels import slstm as slstm_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, nq, n, d, length):
    rng = np.random.RandomState(seed)
    corpus = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
    ids = rng.randint(0, n, (nq, length)).astype(np.int32)
    ids[:, ::3] = ids[:, :1]                 # repeated rows, corpus ends
    ids[:, 1::4] = 0
    ids[:, 2::5] = n - 1
    return corpus, q, ids


@pytest.mark.parametrize("d,length", [(128, 1), (128, 128), (784, 256),
                                      (30, 37)])
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_beam_gather(cuda, d, length, mode):
    corpus, q, ids = _inputs(d, 64, 500, d, length)
    args = [torch.as_tensor(a, device=cuda) for a in (q, ids, corpus)]
    before = bg_mod.launches
    got = ops.beam_gather_distances(*args, mode=mode)
    assert bg_mod.launches == before + 1
    want = ops.beam_gather_distances(*args, mode=mode, force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)


@pytest.mark.parametrize("d,c", [(128, 60), (784, 80), (30, 1), (16, 200)])
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_pair_gather(cuda, d, c, mode):
    corpus, _, ids = _inputs(c, 32, 500, d, c)
    args = [torch.as_tensor(a, device=cuda) for a in (ids, corpus)]
    before = pg_mod.launches
    got = ops.pair_gather_distances(*args, mode=mode)
    assert pg_mod.launches == before + 1
    want = ops.pair_gather_distances(*args, mode=mode, force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)


def _unaligned(corpus, device):
    """A contiguous (N, D) view of `corpus` that starts 4 bytes past a
    16-byte boundary: the kernels' 4-byte gather path."""
    n, d = corpus.shape
    flat = torch.zeros(n * d + 1, device=device)
    view = flat[1:].view(n, d)
    view.copy_(torch.as_tensor(corpus, device=device))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _edge_ids(rng, rows, cols, n):
    """Random ids with duplicates in a row, both corpus ends, and ids past
    either end (the kernels clamp them; the plain versions get the clamped
    ids)."""
    ids = rng.randint(0, n, (rows, cols)).astype(np.int32)
    ids[:, 1::3] = ids[:, :1]
    ids[:, 2::5] = n - 1
    ids[:, 3::7] = 0
    ids[::2, 4::9] = n + 17
    ids[1::2, 5::11] = -3
    return ids


@pytest.mark.parametrize("c", [1, 2, 7, 60, 61, 80, 100, 119, 129, 256])
@pytest.mark.parametrize("d", [128, 30, 784])
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_pair_gather_symmetric_and_edges(cuda, c, d, mode):
    """B2 at the edges of its design: C = 1, C odd with C*C % 4 != 0 (the
    scalar store-out), C = 100 (one node a block, staged through shared
    memory), 119 (one pass, stored directly), 129 and 256 (several passes
    over the tiles), D % 4 != 0 (the 4-byte gather), D = 784 (49 slices),
    duplicated and clamped ids, B not a multiple of the nodes a block
    takes.  The output is exactly symmetric and its l2 diagonal exactly 0,
    and it holds against the plain version on the clamped ids."""
    rng = np.random.RandomState(c * 1000 + d)
    n, b = 300, 13
    corpus = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    ids = torch.as_tensor(_edge_ids(rng, b, c, n), device=cuda)
    got = _same_counts(pg_mod, lambda: ops.pair_gather_distances(
        ids, corpus, mode=mode))
    assert got.shape == (b, c, c)
    assert torch.equal(got, got.transpose(1, 2))
    if mode == "l2":
        assert not got.diagonal(dim1=1, dim2=2).any()
    want = ops.pair_gather_distances(ids.clamp(0, n - 1), corpus, mode=mode,
                                     force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)


@pytest.mark.parametrize("d", [128, 31])
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_pair_gather_unaligned_corpus(cuda, d, mode):
    """A corpus view 4 bytes past a 16-byte boundary takes the 4-byte
    gather and gives the aligned copy's output bit for bit."""
    rng = np.random.RandomState(d)
    corpus = rng.randn(500, d).astype(np.float32)
    ids = torch.as_tensor(_edge_ids(rng, 9, 60, 500), device=cuda)
    view = _unaligned(corpus, cuda)
    got = ops.pair_gather_distances(ids, view, mode=mode)
    same = ops.pair_gather_distances(ids, torch.as_tensor(corpus,
                                                          device=cuda),
                                     mode=mode)
    assert torch.equal(got, same)
    want = ops.pair_gather_distances(ids.clamp(0, 499), view, mode=mode,
                                     force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)


@pytest.mark.parametrize("nq,length", [(1, 1), (1, 256), (3, 37),
                                       (64, 255), (130, 256)])
@pytest.mark.parametrize("d", [128, 30, 784])
@pytest.mark.parametrize("mode", ["l2", "dot"])
@pytest.mark.parametrize("aligned", [True, False])
def test_beam_gather_edges(cuda, nq, length, d, mode, aligned):
    """B1 at the edges: Q = 1, L = 1 and L not a multiple of a warp's rows
    in flight, D % 4 != 0, a corpus view at an unaligned offset (the
    scalar path), duplicated and clamped ids; against the plain version on
    the clamped ids."""
    rng = np.random.RandomState(nq * 7 + length + d)
    n = 400
    corpus = rng.randn(n, d).astype(np.float32)
    x = torch.as_tensor(corpus, device=cuda) if aligned \
        else _unaligned(corpus, cuda)
    q = torch.as_tensor(rng.randn(nq, d).astype(np.float32), device=cuda)
    ids = torch.as_tensor(_edge_ids(rng, nq, length, n), device=cuda)
    got = _same_counts(bg_mod, lambda: ops.beam_gather_distances(
        q, ids, x, mode=mode))
    want = ops.beam_gather_distances(q, ids.clamp(0, n - 1), x, mode=mode,
                                     force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)


def _codes(rng, n, m, k, dtype):
    codes = rng.randint(0, k, (n, m))
    codes[::7] = k - 1                       # the top code (255 at k = 256)
    return torch.as_tensor(codes.astype(
        np.uint8 if dtype == "uint8" else np.int32))


def _words(rng, n, w):
    words = rng.randint(-2 ** 31, 2 ** 31, (n, w), dtype=np.int64)
    words[::5] = -1                          # all-ones words
    words[1::5] = 0
    return torch.as_tensor(words.astype(np.int32))


def _same_counts(mod, fn):
    before = mod.launches
    out = fn()
    assert mod.launches == before + 1
    return out


# ADC sums add the same floats in the same order (i = 0..m-1) as the plain
# versions, so the kernels agree to rounding; rtol 1e-6 leaves room for
# nothing but that.  Hamming is integer arithmetic: exact.
ADC_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,k,length,dtype", [
    (16, 256, 128, "uint8"),    # the PQ search block (width 4 x M0 32)
    (16, 256, 1, "uint8"),      # the entry-point call (LUT from global)
    (16, 256, 256, "uint8"),
    (8, 64, 37, "uint8"),       # m != 16: the generic loop, ragged L
    (6, 16, 45, "uint8"),
    (4, 512, 40, "int32"),      # k > 256: int32 codes
])
def test_beam_gather_adc(cuda, m, k, length, dtype):
    rng = np.random.RandomState(m * k + length)
    n, nq = 500, 33
    lut = torch.as_tensor(rng.rand(nq, m, k).astype(np.float32), device=cuda)
    codes = _codes(rng, n, m, k, dtype).to(cuda)
    ids = torch.as_tensor(_inputs(1, nq, n, 4, length)[2], device=cuda)
    got = _same_counts(bga_mod, lambda: ops.beam_gather_adc(lut, ids, codes))
    want = ops.beam_gather_adc(lut, ids, codes, force_ref=True)
    torch.testing.assert_close(got, want, **ADC_TOL)


@pytest.mark.parametrize("w,length", [(8, 128), (8, 1), (4, 37), (3, 20),
                                      (16, 256)])
def test_beam_gather_hamming(cuda, w, length):
    rng = np.random.RandomState(w * length)
    n, nq = 400, 17
    q = _words(rng, nq, w).to(cuda)
    codes = _words(rng, n, w).to(cuda)
    ids = torch.as_tensor(_inputs(2, nq, n, 4, length)[2], device=cuda)
    got = _same_counts(bgh_mod,
                       lambda: ops.beam_gather_hamming(q, ids, codes))
    want = ops.beam_gather_hamming(q, ids, codes, force_ref=True)
    assert torch.equal(got, want)


def _codes_at(words, offset, device):
    """``words`` on the card, ``offset`` int32 words past a 16-byte
    boundary (1: the kernels' 4-byte path)."""
    n, w = words.shape
    buf = torch.zeros(n * w + offset, dtype=torch.int32, device=device)
    view = buf[offset:].view(n, w)
    view.copy_(words)
    return view


@pytest.mark.parametrize("w,length,nq,offset", [
    (8, 128, 17, 0), (8, 1, 17, 0), (4, 37, 17, 0), (3, 20, 17, 0),
    (16, 256, 17, 0),
    (8, 1, 1024, 0),           # the search's entry-point call
    (8, 128, 1024, 0),         # a search step (width 4 x M0 32)
    (8, 128, 17, 1), (4, 37, 17, 1), (16, 256, 17, 1),   # unaligned codes
])
def test_beam_gather_hamming_entries(cuda, w, length, nq, offset):
    """B4's two entries against their plain versions, one launch a call.
    The fused entry gets the beam's int64 ids with PAD (-1) and ids >= N on
    fresh slots (both clamp), an all-stale query and an all-fresh one."""
    rng = np.random.RandomState(w * length + nq + offset)
    n = 400
    q = _words(rng, nq, w).to(cuda)
    codes = _codes_at(_words(rng, n, w), offset, cuda)
    assert (codes.data_ptr() % 16 == 0) == (offset == 0)
    ids = torch.as_tensor(_inputs(3, nq, n, 4, length)[2], device=cuda)
    got = _same_counts(bgh_mod,
                       lambda: ops.beam_gather_hamming(q, ids, codes))
    assert torch.equal(got, ops.beam_gather_hamming(q, ids, codes,
                                                    force_ref=True))

    ids64 = ids.long()
    ids64[:, ::4] = -1
    ids64[:, 1::5] = n + 7
    fresh = torch.as_tensor(rng.rand(nq, length) < 0.6, device=cuda)
    fresh[:, ::4] = False
    fresh[0] = False
    fresh[-1] = True                 # PAD on a fresh slot reads row 0
    before = (bgh_mod.launches, bgh_mod.masked_launches)
    got = ops.beam_gather_hamming_masked(q, ids64, fresh, codes)
    assert (bgh_mod.launches, bgh_mod.masked_launches) == \
        (before[0], before[1] + 1)
    want = ops.beam_gather_hamming_masked(q, ids64, fresh, codes,
                                          force_ref=True)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(torch.isinf(got), ~fresh)
    if nq > 1:
        assert torch.isinf(got[0]).all()


def test_beam_gather_hamming_masked_refuses_bad_inputs(cuda):
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    codes = torch.zeros((10, 8), dtype=torch.int32, device=cuda)
    ids = torch.zeros((4, 6), dtype=torch.int64, device=cuda)
    fresh = torch.ones((4, 6), dtype=torch.bool, device=cuda)
    fn = bgh_mod.beam_gather_hamming_masked
    for args, match in (((q, ids.int(), fresh, codes), "ids must be"),
                        ((q, ids, fresh.to(torch.uint8), codes), "fresh must"),
                        ((q, ids, fresh[:, :5].contiguous(), codes),
                         "fresh .* is not ids' shape"),
                        ((q, ids.t().contiguous().t(), fresh, codes),
                         "contiguous"),
                        ((q, ids, fresh, codes[:, :4].contiguous()),
                         "shapes"),
                        ((q, ids, fresh, codes.cpu()), "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            fn(*args)


def test_bq_search_one_fused_launch_per_step(cuda):
    """A BQ search on the card launches B4's fused entry once for the
    entry points and once a layer-0 step, and nothing of the TPU-function
    entry; it returns the CPU search's ids, distances and iteration counts
    (Hamming is exact)."""
    from repro_torch.core import BQConfig
    from repro_torch.core import bq as bq_mod
    from repro_torch.core.hnsw_search import search
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    cfg = EngineConfig(dim=32, metric="cosine", builder="bulk",
                       quantization="bq", bq=BQConfig(bits=64),
                       hnsw=HNSWConfig(seed=0))
    cpu = QuantixarEngine(cfg, device="cpu")
    cpu.add(x)
    cpu.build()
    card = QuantixarEngine.from_state_dict(cfg, cpu.state_dict(),
                                           device="cuda")
    out = []
    for eng, dev in ((cpu, "cpu"), (card, cuda)):
        g, ml, _ = eng._device_graph
        qc = eng._bq.encode(torch.as_tensor(q, device=dev))
        before = (bgh_mod.launches, bgh_mod.masked_launches)
        d, i, it = search(g, bq_mod.signs(qc, 64), k=10, ef=64, max_level=ml,
                          metric="hamming", expansion_width=4, q_codes=qc,
                          with_iters=True)
        out.append((d.cpu(), i.cpu(), it.cpu(), bgh_mod.launches - before[0],
                    bgh_mod.masked_launches - before[1]))
    (cd, ci, cit, c_tpu, c_masked), (gd, gi, git, g_tpu, g_masked) = out
    assert (c_tpu, c_masked) == (0, 0)          # the CPU launches nothing
    assert g_tpu == 0 and g_masked == 1 + int(git.max())
    assert torch.equal(gi, ci) and torch.equal(git, cit)
    assert torch.equal(gd, cd)


def test_float_search_one_b1s_launch_per_step(cuda):
    """A float-mode search on the card launches B1ˢ once a layer-0 step and
    B1 once, for the entry points; the PQ and BQ searches launch no B1ˢ;
    the wrapper refuses what it cannot take."""
    from repro_torch.core import BQConfig, PQConfig
    from repro_torch.core.hnsw_search import search
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    cfg = EngineConfig(dim=32, metric="cosine", builder="bulk",
                       hnsw=HNSWConfig(seed=0))
    eng = QuantixarEngine(cfg, device="cuda")
    eng.add(x)
    eng.build()
    g, ml, metric = eng._device_graph
    qd = torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True),
                         device=cuda)
    before = (bg_mod.launches, bg_mod.step_launches)
    _, _, it = search(g, qd, k=10, ef=64, max_level=ml, metric=metric,
                      with_iters=True)
    assert bg_mod.launches - before[0] == 1
    assert bg_mod.step_launches - before[1] == int(it.max()) > 0
    for quant in ("pq", "bq"):
        qcfg = EngineConfig(dim=32, metric="cosine", builder="bulk",
                            quantization=quant, pq=PQConfig(m=8, k=64),
                            bq=BQConfig(bits=64), hnsw=HNSWConfig(seed=0))
        cpu = QuantixarEngine(qcfg, device="cpu")
        cpu.add(x)
        cpu.build()
        card = QuantixarEngine.from_state_dict(qcfg, cpu.state_dict(),
                                               device="cuda")
        mods = (bga_mod, "launches") if quant == "pq" \
            else (bgh_mod, "masked_launches")
        s0, c0 = bg_mod.step_launches, getattr(*mods)
        card.search(q, 10)
        assert bg_mod.step_launches == s0 and getattr(*mods) > c0

    # the wrapper's refusals
    n, d, m0, nq, ef = 300, 32, 16, 4, 64
    vecs = torch.randn(n, d, device=cuda)
    adj0 = torch.randint(0, n, (n, m0), dtype=torch.int32, device=cuda)
    qs = torch.randn(nq, d, device=cuda)

    def state(**kw):
        s = dict(cand_d=torch.full((nq, ef), float("inf"), device=cuda),
                 cand_id=torch.full((nq, ef), -1, dtype=torch.int64,
                                    device=cuda),
                 expanded=torch.zeros((nq, ef), dtype=torch.bool,
                                      device=cuda),
                 visited=torch.zeros((nq, (n + 31) // 32),
                                     dtype=torch.int64, device=cuda),
                 iters=torch.zeros(nq, dtype=torch.int32, device=cuda),
                 active=torch.zeros(nq, dtype=torch.bool, device=cuda))
        s.update(kw)
        return bg_mod.BeamState(**s)

    def make(*args, width=4, mode="l2"):
        return bg_mod.BeamGatherStep(*args, width=width, max_iters=8,
                                     mode=mode)

    make(qs, adj0, vecs, state())                    # takes these
    wide = torch.zeros((nq, 2 * ef), device=cuda)
    for args, kw, match in (
            ((qs.cpu(), adj0, vecs, state()), {}, "CUDA tensor"),
            ((qs, adj0.long(), vecs, state()), {}, "int32"),
            ((qs, adj0, vecs, state(cand_id=torch.zeros(
                (nq, ef), dtype=torch.int32, device=cuda))), {}, "int64"),
            ((qs, adj0, vecs, state(cand_d=wide[:, ::2])), {},
             "contiguous"),
            ((qs, adj0, vecs, state(visited=torch.zeros(
                (nq, 3), dtype=torch.int64, device=cuda))), {}, "shapes"),
            ((qs[:, :8].contiguous(), adj0, vecs, state()), {}, "shapes"),
            ((qs, adj0, vecs, state()), {"width": ef + 1}, "width"),
            ((qs, adj0, vecs, state()), {"mode": "cosine"}, "mode")):
        with pytest.raises(ValueError, match=match):
            make(*args, **kw)


# ---------------------------------------------------------------- B1ˢ
#
# B1ˢ (the HNSW layer-0 step in one launch) against the plain step it
# replaces, on the card, where the plain step's distances are B1's: every
# state tensor, the active and fresh counts, step by step, bit for bit.

def _step_graph(seed, n, d, m0, pad_share, pool, metric, device,
                aligned=True):
    """A layer-0 graph for B1ˢ's checks: each row m0 distinct neighbours
    within ``pool`` ids of the node (so that popped rows share many), a
    share of the slots PAD; rows of d floats, unit rows under dot."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    if metric == "dot":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    off = np.argsort(rng.rand(n, 2 * pool), axis=1)[:, :m0]
    off = off - pool + (off >= pool)                  # [-pool, pool] \ {0}
    adj = ((np.arange(n)[:, None] + off) % n).astype(np.int32)
    adj[rng.rand(n, m0) < pad_share] = -1
    vecs = torch.as_tensor(x, device=device) if aligned \
        else _unaligned(x, device)
    return vecs, torch.as_tensor(adj, device=device)


def _block_dist(q, vecs, metric):
    def block_dist(ids, fresh):
        return torch.where(fresh, ops.beam_gather_distances(
            q, ids.clamp_min(0), vecs, mode=metric), float("inf"))
    return block_dist


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _step_pair(vecs, adj0, q, ep, ef, width, max_iters, metric):
    """B1ˢ and the plain step side by side from one state until every
    query stops, held equal after each step; returns (steps, the final
    state)."""
    from repro_torch.core.hnsw_search import beam_state
    block_dist = _block_dist(q, vecs, metric)
    state = beam_state(ep, ef, max_iters, (vecs.shape[0] + 31) // 32,
                       block_dist)
    twin = bg_mod.BeamState(*(t.clone() for t in state))
    kern = ops.beam_gather_step(q, adj0, vecs, state, width=width,
                                max_iters=max_iters, mode=metric)
    assert isinstance(kern, bg_mod.BeamGatherStep)
    plain = bg_mod.PlainStep(twin, adj0, width, max_iters, block_dist)
    before, steps = bg_mod.step_launches, 0
    n_active = int(state.active.sum())
    while n_active:
        kern()
        plain(count=True)
        steps += 1
        n_active = kern.n_active()
        assert n_active == plain.n_active(), steps
        for name, a, b in zip(bg_mod.BeamState._fields, kern.state,
                              plain.state):
            assert torch.equal(_bits(a), _bits(b)), (steps, name)
        assert kern.fresh() == plain.fresh(), steps
    assert bg_mod.step_launches - before == steps
    return steps, plain.state, plain.fresh()


# (metric, width, ef, D, Q, PAD share, max_iters, aligned): every width
# and ef at D 128; then D 784 and 130 (unaligned: the scalar path), a
# PAD-heavy graph, Q 1 and 1,024, max_iters reached, ef 1,024 (wider
# shapes: WIDE_CASES)
STEP_CASES = [(m, w, ef, 128, 7, 0.0, None, True)
              for m in ("l2", "dot") for w in (1, 4, 8)
              for ef in (32, 64, 100, 256, 512)] + [
    ("l2", 4, 256, 784, 7, 0.5, None, True),
    ("dot", 8, 100, 784, 1, 0.0, None, True),
    ("l2", 8, 64, 130, 7, 0.25, None, True),
    ("dot", 4, 256, 130, 1024, 0.0, None, False),
    ("l2", 4, 256, 128, 1024, 0.0, None, True),
    ("dot", 4, 512, 128, 1024, 0.5, None, True),
    ("l2", 1, 32, 130, 1, 0.5, None, False),
    ("l2", 4, 256, 128, 1024, 0.0, 6, True),
    ("dot", 8, 64, 784, 7, 0.25, 3, True),
    ("l2", 8, 1024, 128, 7, 0.0, None, True)]


@pytest.mark.parametrize("metric,width,ef,d,nq,pad,max_iters,aligned",
                         STEP_CASES)
def test_b1s_steps_equal_the_plain_step(cuda, metric, width, ef, d, nq, pad,
                                        max_iters, aligned):
    n = 4000
    vecs, adj0 = _step_graph(ef + d, n, d, 32, pad, 200, metric, cuda,
                             aligned)
    rng = np.random.RandomState(nq + width)
    q = torch.as_tensor(rng.randn(nq, d).astype(np.float32), device=cuda)
    ep = torch.as_tensor(rng.randint(0, n, nq), device=cuda)
    steps, st, fresh = _step_pair(vecs, adj0, q, ep, ef, width,
                                  max_iters or 4 * ef, metric)
    assert steps > 1 and int(st.iters.max()) == steps
    if max_iters:
        assert steps == max_iters
    elif nq > 1:                       # queries finish at different steps
        assert len(set(st.iters.tolist())) > 1
    assert fresh > 0


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("width", [1, 4, 8])
def test_search_through_b1s_equals_the_plain_step(cuda, metric, width):
    """Whole searches (upper-layer descent, then the layer-0 loop) through
    B1ˢ and through the plain step (``force_ref``) at Q 1, 7 and 1,024:
    the same distances (bits), ids and iteration counts."""
    from repro_torch.core.hnsw_search import search
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    packed = bulk_build_device(x, HNSWConfig(M=16, metric=metric, seed=0),
                               device="cpu")
    g, ml, m = to_device(packed, "cuda")
    for nq in (1, 7, 1024):
        qn = preprocess_vectors(
            gaussian_mixture(nq, 32, n_clusters=15, scale=0.3, seed=nq),
            metric)
        qd = torch.as_tensor(qn, device=cuda)
        out = []
        for force_ref in (False, True):
            b0, s0 = bg_mod.launches, bg_mod.step_launches
            d, i, it = search(g, qd, k=10, ef=64, max_level=ml, metric=m,
                              expansion_width=width, with_iters=True,
                              force_ref=force_ref)
            steps = int(it.max())
            assert (bg_mod.launches - b0, bg_mod.step_launches - s0) == \
                ((1 + steps, 0) if force_ref else (1, steps))
            out.append((_bits(d), i, it))
        for a, b in zip(*out):
            assert torch.equal(a, b), nq


@pytest.mark.parametrize("k", [10, 300])
def test_filtered_search_through_b1s_equals_the_plain_step(cuda,
                                                           monkeypatch, k):
    """The engine's filtered HNSW pass widens ef to max(2 ef, 4 k): 512 at
    k 10, 1,200 at k 300.  B1ˢ takes both, and its hits are the plain
    step's."""
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    eng = QuantixarEngine(EngineConfig(dim=32, metric="cosine",
                                       builder="bulk",
                                       hnsw=HNSWConfig(seed=0)),
                          device="cuda")
    eng.add(x)
    eng.build()
    mask = np.random.RandomState(0).rand(3000) < 0.3
    s0 = bg_mod.step_launches
    got = eng.search(q, k, ef=256, mask=mask)
    assert bg_mod.step_launches > s0
    fused = ops.beam_gather_step
    monkeypatch.setattr(ops, "beam_gather_step", lambda *a, **kw: fused(
        *a, **dict(kw, force_ref=True)))
    s1 = bg_mod.step_launches
    want = eng.search(q, k, ef=256, mask=mask)
    assert bg_mod.step_launches == s1
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))


def _flat_graph(vecs, adj0):
    """A graph of layer 0 alone (entry point node 0)."""
    from repro_torch.core.hnsw_search import HNSWGraph
    dev = vecs.device
    return HNSWGraph(vectors=vecs, adj0=adj0,
                     upper_ids=torch.zeros(0, dtype=torch.int64, device=dev),
                     upper_adj=torch.zeros((0, 0, 1), dtype=torch.int64,
                                           device=dev),
                     entry_global=0, entry_upper=0)


# (metric, width, ef, M0, D, N, Q, max_iters, on the workspace): the
# largest ef and the widest width, width · M0 and D in the tests, past
# where the step's plan leaves shared memory (47 KB: ef ~2,700 at width 4,
# M0 32, D 128; D ~11,000 at ef 64) and past the bitonic network's 256 keys
# a thread each: B1ˢ takes every one
WIDE_CASES = [("l2", 8, 1024, 32, 128, 4000, 7, None, False),
              ("dot", 4, 3000, 32, 128, 4000, 7, 40, True),
              ("l2", 33, 64, 8, 128, 4000, 7, None, False),
              ("dot", 8, 256, 48, 128, 4000, 7, None, False),
              ("l2", 8, 128, 64, 128, 4000, 1024, None, False),
              ("l2", 4, 64, 16, 12100, 1000, 7, None, True)]


@pytest.mark.parametrize("metric,width,ef,m0,d,n,nq,max_iters,work",
                         WIDE_CASES)
def test_b1s_takes_every_shape(cuda, metric, width, ef, m0, d, n, nq,
                               max_iters, work):
    """B1ˢ at shapes past shared memory and past a key a thread, step by
    step against the plain step (every state tensor and count, bit for
    bit), then a whole search through it against ``force_ref``."""
    from repro_torch.core.hnsw_search import search
    work_fn = bg_mod._step_lib()[0]
    assert (work_fn(ef, width, m0, d) > 0) == work
    vecs, adj0 = _step_graph(ef + m0, n, d, m0, 0.1, min(200, n // 3),
                             metric, cuda)
    rng = np.random.RandomState(width)
    q = torch.as_tensor(rng.randn(nq, d).astype(np.float32), device=cuda)
    ep = torch.as_tensor(rng.randint(0, n, nq), device=cuda)
    steps, st, fresh = _step_pair(vecs, adj0, q, ep, ef, width,
                                  max_iters or 4 * ef, metric)
    assert steps > 1 and fresh > 0 and int(st.iters.max()) == steps
    g = _flat_graph(vecs, adj0)
    out, took = [], []
    for force_ref in (False, True):
        s0 = bg_mod.step_launches
        d_, i, it = search(g, q, k=10, ef=ef, max_level=0, metric=metric,
                           expansion_width=width, max_iters=max_iters,
                           with_iters=True, force_ref=force_ref)
        took.append(bg_mod.step_launches - s0)
        out.append((_bits(d_), i, it))
    assert took == [int(out[0][2].max()), 0] and took[0] > 0
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,n", [("coarse", 20000), ("level", 6000)])
def test_bulk_build_through_b1s_equals_the_plain_step(cuda, monkeypatch,
                                                      mode, n):
    """The bulk builder's beam searches (the coarse mode's stitch, the
    level mode's inserts) through B1ˢ build the graph the plain step
    builds: the same layer-0 rows, upper layers and entry point."""
    import functools
    from repro_torch.core import hnsw_bulk
    from repro_torch.core.hnsw_search import search
    x = gaussian_mixture(n, 32, n_clusters=15, scale=0.3, seed=5)
    cfg = HNSWConfig(M=16, metric="cosine", seed=0, bulk_mode=mode,
                     coarse_cluster=4096)
    s0 = bg_mod.step_launches
    got = bulk_build_device(x, cfg, device="cuda")
    assert bg_mod.step_launches > s0
    monkeypatch.setattr(hnsw_bulk, "beam_search",
                        functools.partial(search, force_ref=True))
    s1 = bg_mod.step_launches
    want = bulk_build_device(x, cfg, device="cuda")
    assert bg_mod.step_launches == s1
    for field in ("adj0", "upper_ids", "upper_adj", "levels"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), field)
    assert (got.entry_global, got.entry_upper) == \
        (want.entry_global, want.entry_upper)


# Both B6 paths add the same floats in the same order (acc = 0, then
# i = 0..m-1) as the plain version: the outputs are equal bit for bit.
# path: the one the kernel takes ("query_lanes": Q >= 32, uint8 codes,
# m % 4 == 0, k <= 256, aligned rows; "row_lanes" otherwise).
@pytest.mark.parametrize("nq,n,m,k,dtype,offset,path", [
    (1024, 5000, 16, 256, "uint8", 0, "query_lanes"),  # the flat route's batch
    (5, 9000, 16, 256, "uint8", 1, "row_lanes"),   # 1-byte offset: unaligned
    (9, 333, 8, 64, "uint8", 0, "row_lanes"),
    (2, 100, 6, 16, "uint8", 0, "row_lanes"),
    (3, 700, 4, 512, "int32", 0, "row_lanes"),
    # the batcher's small batches: one query, a few, one tile, a tile and one
    (1, 3000, 16, 256, "uint8", 0, "row_lanes"),
    (7, 3000, 16, 256, "uint8", 0, "row_lanes"),
    (32, 3000, 16, 256, "uint8", 0, "query_lanes"),
    (33, 3000, 16, 256, "uint8", 0, "query_lanes"),
    # query lanes at other widths: m = 4 and 8, k = 64, rows past a tile
    (40, 2100, 8, 64, "uint8", 0, "query_lanes"),
    (64, 1500, 4, 16, "uint8", 0, "query_lanes"),
    (48, 700, 16, 256, "uint8", 1, "row_lanes"),   # unaligned at Q >= 32
    (40, 700, 6, 16, "uint8", 0, "row_lanes"),     # m % 4 != 0
])
def test_pq_adc(cuda, nq, n, m, k, dtype, offset, path):
    rng = np.random.RandomState(nq + n)
    lut = torch.as_tensor(rng.rand(nq, m, k).astype(np.float32), device=cuda)
    codes = _codes(rng, n, m, k, dtype).to(cuda)
    if offset:
        buf = torch.empty(codes.numel() + offset, dtype=codes.dtype,
                          device=cuda)
        codes = buf[offset:].view(n, m)
        codes.copy_(_codes(rng, n, m, k, dtype))
    before = adc_mod.path_launches[path]
    got = _same_counts(adc_mod, lambda: ops.pq_adc_distances(lut, codes))
    assert adc_mod.path_launches[path] == before + 1
    want = ops.pq_adc_distances(lut, codes, force_ref=True)
    assert torch.equal(got, want)


# the flat route's shape, Q = 1,024 x one 65,536-row chunk, and the same
# with a row tail past the last 1,024-row tile
@pytest.mark.parametrize("n", [65536, 65536 + 37])
def test_pq_adc_flat_route_shape(cuda, n):
    rng = np.random.RandomState(n)
    nq, m, k = 1024, 16, 256
    lut = torch.as_tensor(rng.rand(nq, m, k).astype(np.float32), device=cuda)
    codes = _codes(rng, n, m, k, "uint8").to(cuda)
    before = adc_mod.path_launches["query_lanes"]
    got = _same_counts(adc_mod, lambda: ops.pq_adc_distances(lut, codes))
    assert adc_mod.path_launches["query_lanes"] == before + 1
    want = ops.pq_adc_distances(lut, codes, force_ref=True)
    assert torch.equal(got, want)


# every W up to 16 takes the register path (16-byte loads at W = 4, 8, 16
# on aligned rows, a word at a time at W = 1, 2, 3, 5, on rows 4 bytes off
# a 16-byte boundary and past W = kW), past 16 words the generic loop
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nq,n,w", [(1024, 5000, 8), (33, 129, 4),
                                    (2, 50, 16), (1, 1, 1), (40, 3000, 3),
                                    (64, 2000, 2), (50, 1000, 5),
                                    (1024, 4100, 4), (16, 700, 17)])
def test_hamming(cuda, nq, n, w, aligned):
    rng = np.random.RandomState(nq * n + w)
    q = _words(rng, nq, w).to(cuda)
    x = _words(rng, n, w).to(cuda)
    if not aligned:
        flat = torch.zeros(n * w + 1, dtype=torch.int32, device=cuda)
        x = flat[1:].view(n, w).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got = _same_counts(hm_mod, lambda: ops.hamming_distances(q, x))
    want = ops.hamming_distances(q, x, force_ref=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_engine_on_card_matches_cpu(cuda, metric):
    """The default collection built and searched on the card (through both
    kernels) agrees with the same engine on the CPU (plain versions); the
    kernels sum in another order, so near-ties may differ."""
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    cfg = EngineConfig(dim=32, metric=metric, builder="bulk",
                       hnsw=HNSWConfig(seed=0))
    before = (bg_mod.launches, pg_mod.launches)
    hits = []
    for dev in ("cuda", "cpu"):
        eng = QuantixarEngine(cfg, device=dev)
        eng.add(x)
        hits.append(eng.search(q, 10)[1])
    assert bg_mod.launches > before[0] and pg_mod.launches > before[1]
    assert (hits[0] == hits[1]).all(1).mean() >= 0.9


@pytest.mark.parametrize("quant", ["pq", "bq"])
def test_quantized_engine_on_card_matches_cpu(cuda, quant):
    """A PQ / BQ collection built on the CPU and loaded on the card from its
    state_dict (the same codebooks, codes and graph) returns the CPU hits
    through all four code-domain kernels: plain, delta and the ~5 % flat
    route, with the exact rescore.  The ADC kernels add in the plain
    versions' order; Hamming is exact."""
    from repro_torch.core import BQConfig, PQConfig
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    cfg = EngineConfig(dim=32, metric="cosine", builder="bulk",
                       quantization=quant, pq=PQConfig(m=8, k=64),
                       bq=BQConfig(bits=64), hnsw=HNSWConfig(seed=0))
    cpu = QuantixarEngine(cfg, device="cpu")
    cpu.add(x[:2900])
    cpu.build()
    cpu.add(x[2900:])
    card = QuantixarEngine.from_state_dict(cfg, cpu.state_dict(),
                                           device="cuda")
    # (module, counter): BQ's search steps run B4's fused (masked) entry
    mods = ((bga_mod, "launches"), (adc_mod, "launches")) if quant == "pq" \
        else ((bgh_mod, "masked_launches"), (hm_mod, "launches"))
    before = [getattr(m, c) for m, c in mods]
    mask = np.random.RandomState(0).rand(3000) < 0.05
    for queries, kw in ((q, {}), (x[2900:2950], {}), (q, {"mask": mask})):
        (gd, gi), (wd, wi) = (card.search(queries, 10, **kw),
                              cpu.search(queries, 10, **kw))
        # the exact rescore sums a 32-wide dot in another order on the
        # card: a hit may differ only where its cosine to the query ties,
        # within fp32 rounding, that of the CPU's hit in the same slot
        np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-5)
        r, j = np.nonzero(gi != wi)
        unit = x / np.linalg.norm(x, axis=1, keepdims=True)
        qu = queries[r] / np.linalg.norm(queries[r], axis=1, keepdims=True)
        np.testing.assert_allclose((qu * unit[gi[r, j]]).sum(1),
                                   (qu * unit[wi[r, j]]).sum(1),
                                   rtol=0, atol=1e-5)
    assert all(getattr(m, c) > b for (m, c), b in zip(mods, before))


def _l2_tol(want, q, x):
    """rtol as the JAX package's l2 kernel test, plus an atol scaled by
    |q|·|x|: the kernel sums D products in another order than the plain
    version, and the norm expansion cancels where q and x nearly agree."""
    return 2e-4 * want.abs() + 1e-5 * q.norm(dim=1)[:, None] * x.norm(dim=1)


# every axis's tail: Q from 1 to 10,000 (the batcher's buckets, Q <= 32,
# swap the kernel's roles), the flat route's 65,536-row chunk and the
# 16,960-row last chunk of 1M, N = 60,000, a power-of-two delta pad, D in
# {128, 256, 784}, a D that is not a multiple of 4 or 16 (plain loads, no
# TMA), N not a multiple of 4, and Q and N on either side of the kernel's
# 64-row wgmma and 128-row tiles
L2_SHAPES = [
    (1, 16960, 128), (7, 16960, 128), (32, 16960, 128), (33, 16960, 128),
    (1024, 65536, 128), (904, 8192, 256), (100, 60000, 784),
    (10000, 3000, 128), (5, 301, 130), (40, 77, 7), (3, 5, 1),
    (63, 127, 128), (64, 129, 128), (65, 127, 128), (65, 129, 784)]


@pytest.mark.parametrize("nq,n,d", L2_SHAPES)
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_l2_distance(cuda, nq, n, d, mode):
    rng = np.random.RandomState(nq + n + d)
    x = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    q = torch.as_tensor(rng.randn(nq, d).astype(np.float32), device=cuda)
    dup = min(nq // 2, n)
    q[:dup] = x[:dup] + 1e-3                 # near-duplicates: l2 cancels
    fn = ops.l2_distances if mode == "l2" else ops.dot_distances
    got = _same_counts(l2_mod, lambda: fn(q, x))
    want = fn(q, x, force_ref=True)
    assert ((got - want).abs() <= _l2_tol(want, q, x)).all()
    if mode == "l2":
        assert (got >= 0).all()


def test_l2_distance_unaligned_rows(cuda):
    """Inputs one float off 16-byte alignment take the plain-load path (TMA
    needs 16-byte aligned rows), in both entries."""
    rng = np.random.RandomState(3)
    buf = torch.as_tensor(rng.randn(500 * 128 + 1).astype(np.float32),
                          device=cuda)
    x = buf[1:].view(500, 128)
    q = torch.as_tensor(rng.randn(70, 128).astype(np.float32), device=cuda)
    for fn, mode in ((ops.l2_distances, "l2"), (ops.dot_distances, "dot")):
        got = _same_counts(l2_mod, lambda: fn(q, x))
        want = fn(q, x, force_ref=True)
        assert ((got - want).abs() <= _l2_tol(want, q, x)).all()
        before = l2_mod.topk_launches
        d, i = ops.l2_topk(q, x, 10, mode=mode)
        assert l2_mod.topk_launches == before + 1
        wd, wi = topk_smallest(got, 10)
        assert torch.equal(i, wi)
        assert torch.equal(d.view(torch.int32), wd.view(torch.int32))


def _tied(rng, nq, n, d, device):
    """Gaussian rows with duplicate corpus rows (tied distances), zero
    corpus rows (dot = -0.0) and near-duplicate queries."""
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
    x[1::7] = x[0]
    x[3::11] = 0.0
    dup = min(nq // 2, n)
    q[:dup] = x[:dup] + 1e-3
    return (torch.as_tensor(q, device=device),
            torch.as_tensor(x, device=device))


@pytest.mark.parametrize("nq,n,d", L2_SHAPES)
@pytest.mark.parametrize("mode", ["l2", "dot", "cosine"])
def test_l2_topk_matches_the_matrix_entry(cuda, nq, n, d, mode):
    """The fused entry is topk_smallest over the matrix entry's output
    (cosine: 1.0 + its dot mode), masked rows at +inf, bit for bit:
    values and indices, ties, -0.0, masks leaving fewer live rows than k."""
    rng = np.random.RandomState(nq + n + d)
    q, x = _tied(rng, nq, n, d, cuda)
    mat = l2_mod.l2_distance(q, x, mode="l2" if mode == "l2" else "dot")
    if mode == "cosine":
        mat = 1.0 + mat
    sparse = torch.zeros(n, dtype=torch.bool, device=cuda)
    sparse[::max(1, n // 5)] = True               # at most ~5 live rows
    masks = [None, torch.as_tensor(rng.rand(n) < 0.4, device=cuda), sparse]
    for k in (1, 10, 40, 256):
        if k > n:
            continue
        for mask in masks:
            full = mat if mask is None else \
                mat.masked_fill(~mask[None], float("inf"))
            wd, wi = topk_smallest(full, k)
            before = l2_mod.topk_launches
            got_d, got_i = l2_mod.l2_topk(q, x, k, mode=mode, mask=mask)
            assert l2_mod.topk_launches == before + 1
            assert torch.equal(got_i, wi), (k, mask is None)
            assert torch.equal(got_d.view(torch.int32),
                               wd.view(torch.int32)), (k, mask is None)


@pytest.mark.parametrize("nq", [1, 32])
@pytest.mark.parametrize("d", [7, 32])
@pytest.mark.parametrize("k", [10, 256])
@pytest.mark.parametrize("mode", ["l2", "dot", "cosine"])
def test_l2_topk_swapped_roles_many_tiles(cuda, nq, d, k, mode):
    """Q <= 32 (roles swapped) with D <= 32 (one stage a tile) over enough
    rows that every block walks two or more tiles: each tile's epilogue
    stages it in shared memory behind the previous tile's slow insertions
    (lists far from full at k = 256), and must still equal topk_smallest
    over the matrix entry bit for bit."""
    n = 40_000
    rng = np.random.RandomState(nq + d + k)
    q, x = _tied(rng, nq, n, d, cuda)
    mat = l2_mod.l2_distance(q, x, mode="l2" if mode == "l2" else "dot")
    if mode == "cosine":
        mat = 1.0 + mat
    assert -(-n // 128) >= 2 * l2_mod.splits(nq, n, q.device)
    mask = torch.as_tensor(rng.rand(n) < 0.5, device=cuda)
    for m in (None, mask):
        full = mat if m is None else mat.masked_fill(~m[None], float("inf"))
        wd, wi = topk_smallest(full, k)
        got_d, got_i = l2_mod.l2_topk(q, x, k, mode=mode, mask=m)
        assert torch.equal(got_i, wi), m is None
        assert torch.equal(got_d.view(torch.int32), wd.view(torch.int32))


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_flat_search_on_card_runs_the_fused_entry(cuda, metric):
    """flat_search on the card: one fused launch over the whole corpus,
    equal bit for bit to the chunked scan over the matrix entry (what it
    ran before), mask and base_index included; k past FUSED_MAX_K (101,
    256, and 257, past the fused entry's own limit), and on a corpus of at
    most MATRIX_MAX_N rows k past the fused entry's fast k (17 and 100 at
    Q = 40 over 3,000 rows; over 9,000 they stay fused), takes the matrix
    entry and the chunked scan explicitly."""
    from repro_torch.core.distances import get_metric
    from repro_torch.core.flat import MATRIX_MAX_N, scan_topk, takes_fused
    pair = get_metric(metric)
    for n in (3000, 9000):
        rng = np.random.RandomState(8)
        q, x = _tied(rng, 40, n, 32, cuda)
        mask = torch.as_tensor(rng.rand(n) < 0.3, device=cuda)
        for k in (10, 17, FUSED_MAX_K, FUSED_MAX_K + 1, 256, 257):
            before = (l2_mod.launches, l2_mod.topk_launches)
            d, i = flat_search(q, x, k, metric=metric, chunk=1024, mask=mask,
                               base_index=7)
            fused = takes_fused(metric, 40, n, k)
            assert fused == (k <= (16 if n <= MATRIX_MAX_N
                                   else FUSED_MAX_K))
            assert (l2_mod.launches > before[0]) != fused
            assert l2_mod.topk_launches == before[1] + int(fused)
            wd, wi = scan_topk(lambda lo, hi: pair(q, x[lo:hi]), n, k,
                               chunk=1024, mask=mask, base_index=7)
            assert torch.equal(i, wi)
            assert torch.equal(d.view(torch.int32), wd.view(torch.int32))


@pytest.mark.parametrize("nq", [1, 32, 33, 1024])
def test_fused_fast_k_is_the_kernels(cuda, nq):
    """The dispatch's copy of the fused entry's fast k (`fused_fast_k`,
    kept in Python so that the CPU needs no library) equals the limit the
    kernel itself uses (`l2_topk_fast_k`)."""
    from repro_torch.core.flat import fused_fast_k
    assert fused_fast_k(nq) == l2_mod.fast_k(nq)


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("chunk", [None, 16, 50])
@pytest.mark.parametrize("live", [0, 3, 30])
def test_flat_search_empty_slots_on_card(cuda, metric, chunk, live):
    """A mask that leaves fewer than k rows: the card's fused entry returns
    what the CPU scan returns, -1 in the +inf slots where chunk < N and
    the masked rows' ids unchunked."""
    rng = np.random.RandomState(live)
    x = rng.randn(50, 8).astype(np.float32)
    q = rng.randn(4, 8).astype(np.float32)
    mask = np.zeros(50, dtype=bool)
    mask[rng.permutation(50)[:live]] = True
    got = flat_search(torch.as_tensor(q, device=cuda),
                      torch.as_tensor(x, device=cuda), 5, metric=metric,
                      chunk=chunk, mask=torch.as_tensor(mask, device=cuda),
                      base_index=100)
    want = flat_search(torch.as_tensor(q), torch.as_tensor(x), 5,
                       metric=metric, chunk=chunk,
                       mask=torch.as_tensor(mask), base_index=100)
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-4, atol=2e-4)
    if chunk == 16:
        assert (want[1][torch.isinf(want[0])] == -1).all()


def test_l2_distance_64bit_offsets(cuda):
    """Q * N past 2**31 output elements: the last rows land where a 32-bit
    offset would wrap."""
    nq, n, d = 32800, 65536, 16
    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    q = torch.as_tensor(rng.randn(nq, d).astype(np.float32), device=cuda)
    assert nq * n > 2 ** 31
    got = _same_counts(l2_mod, lambda: ops.dot_distances(q, x))
    for rows in (slice(0, 3), slice(nq - 3, nq)):
        want = ops.dot_distances(q[rows], x, force_ref=True)
        assert ((got[rows] - want).abs()
                <= _l2_tol(want, q[rows], x)).all()


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_exact_collection_on_card_matches_cpu(cuda, metric):
    """An exact (flat) collection through the public API on the card, whose
    every scan runs B5's fused entry (l2_topk), returns the CPU collection's
    hits (plain versions): plain, filtered and batched queries."""
    from repro_torch.api import Database, KeywordField, VectorField
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    ids = [f"id-{i}" for i in range(len(x))]
    payloads = [{"cat": f"c{i % 4}"} for i in range(len(x))]
    out = []
    before = l2_mod.topk_launches
    for dev in ("cuda", "cpu"):
        db = Database(device=dev)
        col = db.create_collection(
            name="exact", vector=VectorField(dim=32, metric=metric,
                                             index="flat"),
            fields=(KeywordField("cat"),))
        col.upsert(ids, x, payloads)
        batched = col.query(q).top_k(10).run()
        single = col.query(q[0]).top_k(10).run()
        filtered = col.query(q).filter(cat="c1").top_k(10).run()
        out.append((batched + [single] + filtered))
        db.close()
    assert l2_mod.topk_launches > before
    # the kernel sums in another order than the CPU: two hits may trade
    # places only where their scores tie within fp32 rounding
    for got, want in zip(*out):
        assert len(got) == len(want) == 10
        gs = np.array([h.score for h in got])
        ws = np.array([h.score for h in want])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
        for g, w in zip(got, want):
            assert g.id == w.id or abs(g.score - w.score) <= 1e-4


# B8 against its plain version: |h| <= 1 (c / n is a weighted mean of tanh
# values), so fp32 may differ by summation order (1e-4) and bf16 by one ulp
# at 1 (2^-7) where the fp32 values round to neighbouring bf16 numbers
SLSTM_ATOL = {torch.float32: 1e-4, torch.bfloat16: 7.9e-3}


def _slstm_inputs(seed, b, s, d, h, dtype, device):
    rng = np.random.RandomState(seed)
    blk = d // h
    gates = rng.randn(b, s, 4 * d).astype(np.float32)
    # the model's scales, and a recurrent matrix that is not symmetric
    r = (rng.randn(4, h, blk, blk) / np.sqrt(blk)).astype(np.float32)
    bias = (0.5 * rng.randn(4 * d)).astype(np.float32)
    bias[d:2 * d] += 3.0
    return (torch.as_tensor(gates, device=device).to(dtype),
            torch.as_tensor(r, device=device),
            torch.as_tensor(bias, device=device))


# widths (d, heads): the JAX kernel tests' blk = 8 (tests/test_kernels.py),
# blk = 4 and 5 (tails inside a 16-unit tile), the smoke width (blk = 32)
# and xlstm-1.3b's full width (blk = 512)
@pytest.mark.parametrize("d,h", [(32, 4), (16, 2), (64, 8), (16, 4),
                                 (20, 4), (64, 2), (2048, 4)])
@pytest.mark.parametrize("b,s", [(1, 1), (3, 37), (8, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_sequence(cuda, d, h, b, s, dtype):
    g, r, bias = _slstm_inputs(d + s, b, s, d, h, dtype, cuda)
    before = slstm_mod.launches
    got = ops.slstm_sequence(g, r, bias, n_heads=h)
    assert slstm_mod.launches == before + 1
    want = ops.slstm_sequence(g, r, bias, n_heads=h, force_ref=True)
    assert slstm_mod.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, d)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= SLSTM_ATOL[dtype], err
    # the transposed layout would be another function
    swapped = ops.slstm_sequence(g, r.transpose(2, 3).contiguous(), bias,
                                 n_heads=h, force_ref=True)
    if s > 1 and d // h > 1:
        assert (swapped.float() - got.float()).abs().max().item() > 1e-3


# R's columns that do not fit in shared memory (blk = 2,048), and more tiles
# than blocks on the card at once (blk = 3,072: each block walks several)
@pytest.mark.parametrize("d,h", [(4096, 2), (6144, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_sequence_r_from_l2(cuda, d, h, dtype):
    g, r, bias = _slstm_inputs(d, 3, 37, d, h, dtype, cuda)
    got = ops.slstm_sequence(g, r, bias, n_heads=h)
    want = ops.slstm_sequence(g, r, bias, n_heads=h, force_ref=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= SLSTM_ATOL[dtype], err


# xlstm-1.3b's full width takes the cluster path (no cooperative launch):
# one cluster of 16 blocks a (head, batch-row group); two calls on the same
# inputs are equal (a fixed summation order); B = 1 at the full sequence
@pytest.mark.parametrize("b,s", [(8, 64), (1, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_sequence_full_width_cluster_path(cuda, b, s, dtype):
    d, h = 2048, 4
    g, r, bias = _slstm_inputs(s + b, b, s, d, h, dtype, cuda)
    before = dict(slstm_mod.path_launches)
    got = ops.slstm_sequence(g, r, bias, n_heads=h)
    again = ops.slstm_sequence(g, r, bias, n_heads=h)
    assert slstm_mod.path_launches["cluster"] == before["cluster"] + 2
    assert slstm_mod.path_launches["l2"] == before["l2"]
    assert slstm_mod.last_launch["cluster_size"] == 16
    want = ops.slstm_sequence(g, r, bias, n_heads=h, force_ref=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= SLSTM_ATOL[dtype], err


# the widths that take each path: head widths that are multiples of 32 up to
# 512 the cluster path, the others (and wider heads) the l2 path
@pytest.mark.parametrize("d,h,path", [(64, 2, "cluster"), (256, 2, "cluster"),
                                      (512, 1, "cluster"), (512, 2, "cluster"),
                                      (20, 4, "l2"),
                                      (64, 8, "l2"), (4096, 2, "l2")])
def test_slstm_sequence_path_by_width(cuda, d, h, path):
    g, r, bias = _slstm_inputs(d, 2, 5, d, h, torch.float32, cuda)
    before = slstm_mod.path_launches[path]
    got = ops.slstm_sequence(g, r, bias, n_heads=h)
    assert slstm_mod.path_launches[path] == before + 1
    want = ops.slstm_sequence(g, r, bias, n_heads=h, force_ref=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= SLSTM_ATOL[torch.float32]


def test_slstm_step_floor_runs_the_cluster_layout(cuda):
    layout = slstm_mod.step_floor(8, 16, 2048, 4, cuda)
    torch.cuda.synchronize()
    assert layout["path"] == "cluster" and layout["cluster_size"] == 16
    with pytest.raises(RuntimeError, match="launch failed"):
        slstm_mod.step_floor(2, 16, 20, 4, cuda)


def test_slstm_sequence_refuses_bad_inputs(cuda):
    g, r, bias = _slstm_inputs(0, 2, 4, 32, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of n_heads"):
        slstm_mod.slstm_sequence(g, r, bias, n_heads=3)
    with pytest.raises(ValueError, match="float32 or"):
        slstm_mod.slstm_sequence(g.half(), r, bias, n_heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        slstm_mod.slstm_sequence(g.transpose(0, 1), r, bias, n_heads=4)


# B8's saving entry (training): the serving entry's launch with one more
# store per field, so its h has the serving entry's bits on both paths; its
# save is the plain save within B8's fp32 tolerance (|c|, |n| grow with the
# sequence: relative to each field's largest value)
@pytest.mark.parametrize("d,h,path", [(64, 2, "cluster"), (2048, 4, "cluster"),
                                      (20, 4, "l2"), (64, 8, "l2"),
                                      (4096, 2, "l2")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_save_entry_has_the_serving_bits(cuda, d, h, path, dtype):
    g, r, bias = _slstm_inputs(d + 1, 3, 37, d, h, dtype, cuda)
    serving = slstm_mod.slstm_sequence(g, r, bias, n_heads=h)
    before = (slstm_mod.launches, slstm_mod.save_launches,
              slstm_mod.path_launches[path])
    got, saved = slstm_mod.slstm_sequence_save(g, r, bias, n_heads=h)
    assert (slstm_mod.launches, slstm_mod.save_launches,
            slstm_mod.path_launches[path]) == tuple(x + 1 for x in before)
    _, want = ref.slstm_sequence_save_ref(g, r, bias, h)
    torch.cuda.synchronize()
    assert torch.equal(got, serving)
    assert saved.shape == (8, 3, 37, d) and saved.dtype == torch.float32
    assert torch.equal(saved[7].to(dtype), got)
    for f in range(8):
        scale = want[f].abs().max().item()
        err = (saved[f] - want[f]).abs().max().item()
        assert err <= 1e-4 * max(scale, 1.0), (ref.SLSTM_SAVED[f], err)


def _rel_l2(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm().clamp_min(1e-30)).item()


# B8ᵀ against the plain reverse loop on the same saved forward and the same
# cotangent: fp32 within 1e-4 relative L2 per tensor (summation order over
# S steps).  With bf16 gates both round their f32 dpre, which agree within
# 1e-4, to bf16: they differ only where the f32 values straddle a rounding
# boundary, by one bf16 step (2^-8 relative) on those few elements, so 1e-3
# for dgates; dr and db come from the f32 dpre in both
SLSTM_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("d,h", [(32, 4), (20, 4), (64, 2), (64, 8),
                                 (2048, 4), (4096, 2)])
@pytest.mark.parametrize("b,s", [(1, 1), (3, 37), (8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_backward(cuda, d, h, b, s, dtype):
    g, r, bias = _slstm_inputs(d + s + b, b, s, d, h, dtype, cuda)
    dy = torch.as_tensor(np.random.RandomState(s).randn(b, s, d).astype(
        np.float32), device=cuda).to(dtype)
    _, saved = slstm_mod.slstm_sequence_save(g, r, bias, n_heads=h)
    before = slstm_mod.backward_launches
    # head widths 32 (64 / 2) and 512 (2048 / 4) take the cluster path
    path = "cluster" if (d, h) in {(64, 2), (2048, 4)} else "l2"
    before_path = slstm_mod.backward_path_launches[path]
    dgates, dpre = slstm_mod.slstm_backward(dy, saved, r, n_heads=h)
    assert slstm_mod.backward_launches == before + 1
    assert slstm_mod.backward_path_launches[path] == before_path + 1
    assert slstm_mod.last_backward_launch["path"] == path
    want_g, want_p = ref.slstm_sequence_backward_ref(dy, saved, r, h, dtype)
    torch.cuda.synchronize()
    assert dgates.dtype == dtype and dpre.dtype == torch.float32
    assert dgates.shape == (b, s, 4 * d)
    assert (dgates is dpre) == (dtype == torch.float32)
    assert _rel_l2(dpre, want_p) <= SLSTM_GRAD_RTOL[torch.float32]
    assert _rel_l2(dgates, want_g) <= SLSTM_GRAD_RTOL[dtype]
    again, _ = slstm_mod.slstm_backward(dy, saved, r, n_heads=h)
    assert torch.equal(again, dgates)


def _slstm_backward_case(seed, b, s, d, h, dtype, device):
    """B8's saved forward and a cotangent N(0, 1) for B8ᵀ: (dy, saved, r)."""
    g, r, bias = _slstm_inputs(seed, b, s, d, h, dtype, device)
    dy = torch.as_tensor(np.random.RandomState(seed + 1).randn(b, s, d)
                         .astype(np.float32), device=device).to(dtype)
    _, saved = slstm_mod.slstm_sequence_save(g, r, bias, n_heads=h)
    return dy, saved, r


# B8ᵀ's path by head width, as B8's: multiples of 32 up to 512 the cluster
# path (a cluster of blk / 32 blocks), the others the l2 path; each held to
# the plain reverse loop
@pytest.mark.parametrize("d,h,path", [(64, 2, "cluster"), (256, 2, "cluster"),
                                      (512, 1, "cluster"),
                                      (2048, 4, "cluster"), (20, 4, "l2"),
                                      (64, 8, "l2"), (4096, 2, "l2")])
def test_slstm_backward_path_by_width(cuda, d, h, path):
    dy, saved, r = _slstm_backward_case(d, 2, 5, d, h, torch.float32, cuda)
    before = dict(slstm_mod.backward_path_launches)
    dgates, dpre = slstm_mod.slstm_backward(dy, saved, r, n_heads=h)
    other = "l2" if path == "cluster" else "cluster"
    assert slstm_mod.backward_path_launches[path] == before[path] + 1
    assert slstm_mod.backward_path_launches[other] == before[other]
    layout = slstm_mod.last_backward_launch
    assert layout["path"] == path
    if path == "cluster":
        assert layout["cluster_size"] == d // h // 32
    _, want = ref.slstm_sequence_backward_ref(dy, saved, r, h, torch.float32)
    torch.cuda.synchronize()
    assert _rel_l2(dpre, want) <= SLSTM_GRAD_RTOL[torch.float32]


# xlstm-1.3b's full width on B8ᵀ's cluster path: clusters of 16 blocks,
# two calls on the same inputs equal bit for bit (the partial sums are
# added in a fixed order); B = 1 at the full sequence
@pytest.mark.parametrize("b,s", [(8, 64), (1, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_backward_full_width_cluster_path(cuda, b, s, dtype):
    d, h = 2048, 4
    dy, saved, r = _slstm_backward_case(s + b, b, s, d, h, dtype, cuda)
    before = dict(slstm_mod.backward_path_launches)
    dgates, dpre = slstm_mod.slstm_backward(dy, saved, r, n_heads=h)
    again, again_p = slstm_mod.slstm_backward(dy, saved, r, n_heads=h)
    assert slstm_mod.backward_path_launches["cluster"] == before["cluster"] + 2
    assert slstm_mod.backward_path_launches["l2"] == before["l2"]
    assert slstm_mod.last_backward_launch["cluster_size"] == 16
    want_g, want_p = ref.slstm_sequence_backward_ref(dy, saved, r, h, dtype)
    torch.cuda.synchronize()
    assert torch.equal(dgates, again) and torch.equal(dpre, again_p)
    assert _rel_l2(dpre, want_p) <= SLSTM_GRAD_RTOL[torch.float32]
    assert _rel_l2(dgates, want_g) <= SLSTM_GRAD_RTOL[dtype]


def test_slstm_backward_step_floor_runs_the_cluster_layout(cuda):
    layout = slstm_mod.backward_step_floor(8, 16, 2048, 4, cuda)
    torch.cuda.synchronize()
    assert layout["path"] == "cluster" and layout["cluster_size"] == 16
    with pytest.raises(RuntimeError, match="launch failed"):
        slstm_mod.backward_step_floor(2, 16, 20, 4, cuda)


# the whole autograd function: kernel forward + B8ᵀ against the plain
# forward + reverse loop, through ops.slstm_sequence under grad
@pytest.mark.parametrize("d,h", [(64, 2), (20, 4), (2048, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_sequence_grad_on_card(cuda, d, h, dtype):
    g, r, bias = _slstm_inputs(d, 4, 64, d, h, dtype, cuda)
    dy = torch.as_tensor(np.random.RandomState(1).randn(4, 64, d).astype(
        np.float32), device=cuda).to(dtype)
    grads = []
    for force_ref in (False, True):
        ins = [t.detach().clone().requires_grad_() for t in (g, r, bias)]
        before = slstm_mod.backward_launches
        out = ops.slstm_sequence(*ins, n_heads=h, force_ref=force_ref)
        out.backward(dy)
        assert slstm_mod.backward_launches == before + (not force_ref)
        grads.append([t.grad for t in ins])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert _rel_l2(got, want) <= SLSTM_GRAD_RTOL[got.dtype]


def test_slstm_backward_refuses_bad_inputs(cuda):
    g, r, bias = _slstm_inputs(0, 2, 4, 32, 4, torch.float32, cuda)
    _, saved = slstm_mod.slstm_sequence_save(g, r, bias, n_heads=4)
    dy = torch.zeros((2, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="not \\(8, B, S, d\\)"):
        slstm_mod.slstm_backward(dy[:, :3].contiguous(), saved, r, n_heads=4)
    with pytest.raises(ValueError, match="heads"):
        slstm_mod.slstm_backward(dy, saved, r, n_heads=2)
    with pytest.raises(ValueError, match="float32 or"):
        slstm_mod.slstm_backward(dy.half(), saved, r, n_heads=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_forward_on_card_matches_plain(cuda, dtype):
    """xlstm-1.3b at smoke width on the card: forward through the kernel
    against forward(force_ref=True), one kernel call per sLSTM layer; in
    fp32 also teacher-forced decode against forward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params)
    cfg = get_smoke_config("xlstm-1.3b").with_overrides(dtype=dtype)
    model = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0),
                        device=cuda)
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (3, 64)), device=cuda)
    before = slstm_mod.launches
    got, _ = forward(model, {"tokens": toks}, cfg)
    assert slstm_mod.launches == before + cfg.n_layers // 2
    want, _ = forward(model, {"tokens": toks}, cfg, force_ref=True)
    assert torch.isfinite(got).all()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        st = init_decode_state(cfg, 3, 64, device=cuda)
        for t in range(toks.shape[1]):
            step, st = decode_step(model, st, toks[:, t:t + 1], cfg)
            torch.testing.assert_close(step[:, 0], got[:, t], rtol=0,
                                       atol=1e-4)
    else:
        assert (got - want).abs().max().item() <= 0.15
        assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.9


# ---------------------------------------------------------------------------
# IVF and the sharded collection on the card
# ---------------------------------------------------------------------------

def _near_tie_ids(got_d, got_i, want_d, want_i, atol):
    """ids equal wherever the CPU's neighbouring distances are not within
    ``atol`` of each other; distances within ``atol``."""
    np.testing.assert_allclose(got_d, want_d, rtol=2e-4, atol=atol)
    for r, c in zip(*np.nonzero(got_i != want_i)):
        near = np.abs(want_d[r] - want_d[r, c]) <= 2e-4 * abs(
            want_d[r, c]) + atol
        assert got_i[r, c] in set(want_i[r][near].tolist()), (r, c)


@pytest.mark.parametrize("quant", ["none", "pq", "bq"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_ivf_engine_on_card_matches_cpu(cuda, quant, metric):
    """An IVF engine built on the CPU and loaded on the card (the same
    centroids and lists) returns the CPU hits: the coarse probe on B5's
    fused entry, the probed lists on B1's fused list-major entry (k = 10:
    ``beam_gather_lists_topk``; diff-square-sum
    where the CPU takes the norm expansion: ids equal up to near-ties,
    distances within B1's tolerance), the delta scan and the ~5 % flat
    route."""
    from repro_torch.core import BQConfig, IVFConfig, PQConfig
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    cfg = EngineConfig(dim=32, metric=metric, index="ivf",
                       quantization=quant, pq=PQConfig(m=8, k=64),
                       bq=BQConfig(bits=64),
                       ivf=IVFConfig(nlist=32, nprobe=6))
    cpu = QuantixarEngine(cfg, device="cpu")
    cpu.add(x[:2900])
    cpu.build()
    cpu.add(x[2900:])
    card = QuantixarEngine.from_state_dict(cfg, cpu.state_dict(),
                                           device="cuda")
    bg0, tk0 = bg_mod.topk_launches, l2_mod.topk_launches
    mask = np.random.RandomState(0).rand(3000) < 0.05
    norms = np.linalg.norm(x, axis=1).max() * np.linalg.norm(q, axis=1).max()
    for queries, kw in ((q, {}), (x[2900:2950], {}), (q, {"mask": mask}),
                        (q, {"rescore": False})):
        (gd, gi), (wd, wi) = (card.search(queries, 10, **kw),
                              cpu.search(queries, 10, **kw))
        _near_tie_ids(gd, gi, wd, wi, atol=1e-5 * norms)
    assert bg_mod.topk_launches > bg0 and l2_mod.topk_launches > tk0


@pytest.mark.parametrize("slack", [1.5, 1.02, 0.5])
def test_ivf_build_lists_on_card_equal_cpu(cuda, slack):
    """build_lists on the card gives the CPU's lists bit for bit from the
    same centroids, overflow and dropped rows included.  Integer rows and
    centroids keep every distance exact on both devices, so the lists
    differ only if the assignment rule does (exact ties go to the lower
    centroid on both)."""
    from repro_torch.core import IVFConfig, IVFIndex
    rng = np.random.RandomState(4)
    x = rng.randint(-4, 5, (20000, 24)).astype(np.float32)
    cent = torch.as_tensor(x[rng.choice(20000, 64, replace=False)])
    cfg = IVFConfig(nlist=64, metric="l2", list_slack=slack)
    cpu = IVFIndex(cfg, device="cpu")
    card = IVFIndex(cfg, device="cuda")
    cpu.centroids, card.centroids = cent, cent.to(cuda)
    cpu.build_lists(x)
    card.build_lists(x)
    assert torch.equal(card.lists.cpu(), cpu.lists)
    np.testing.assert_array_equal(card.list_sizes, cpu.list_sizes)
    assert (cpu.list_sizes == cpu.lists.shape[1]).sum() > 1


def test_beam_gather_at_an_ivf_shape_with_pad(cuda):
    """B1 at an IVF shape: thousands of candidates a query, PAD (-1) slots
    that read row 0 (clamped, as JAX's gather does) and are masked by the
    caller; its plain version on the clamped ids."""
    rng = np.random.RandomState(8)
    corpus = rng.randn(20000, 128).astype(np.float32)
    q = rng.randn(48, 128).astype(np.float32)
    ids = rng.randint(0, 20000, (48, 8 * 1465)).astype(np.int32)
    ids[:, 1400:1465] = -1
    ids[:, -300:] = -1
    args = [torch.as_tensor(a, device=cuda) for a in (q, ids, corpus)]
    before = bg_mod.launches
    got = ops.beam_gather_distances(*args, mode="l2")
    assert bg_mod.launches == before + 1
    want = ops.beam_gather_distances(args[0], args[1].clamp_min(0), args[2],
                                     mode="l2", force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * 128)


def test_ivf_search_refuses_too_many_candidates(cuda):
    """One query's nprobe x max_list slots past the list-major entry's
    int32 output offsets: refused before any launch (the lists are a
    zero-memory view, never read)."""
    from repro_torch.core.ivf import _ivf_search
    from repro_torch.kernels.beam_gather import MAX_LIST_SLOTS
    lists = torch.zeros(1, dtype=torch.int32, device=cuda).expand(
        2, MAX_LIST_SLOTS // 2 + 1)
    x = torch.randn(4, 8, device=cuda)
    before = bg_mod.lists_launches
    with pytest.raises(ValueError, match="beam_gather_lists"):
        _ivf_search(x, x[:1], x[:2], lists, 5, 2)
    assert bg_mod.lists_launches == before


def _lists_case(seed, nq, nprobe, nlist, m, n, d, skew, empty=()):
    """Seeded inputs of the list-major entry: packed lists (``empty`` ones
    hold nothing, list 1 a PAD inside its live length), distinct lists a
    query, with ``skew`` every query's first probe on list 0 (several tiles
    of one list), the last two lists probed by none where nprobe leaves
    room."""
    rng = np.random.RandomState(seed)
    corpus = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
    lists = np.full((nlist, m), -1, dtype=np.int32)
    for lst in range(nlist):
        size = 0 if lst in empty else rng.randint(3, m + 1)
        lists[lst, :size] = rng.randint(0, n, size)
    lists[1, 1] = -1
    pool = nlist if nprobe > nlist - 2 else nlist - 2
    probe = np.empty((nq, nprobe), dtype=np.int32)
    for i in range(nq):
        perm = rng.permutation(pool)
        if skew:
            perm = np.concatenate([[0], perm[perm != 0]])
        probe[i] = perm[:nprobe]
    return q, probe, lists, corpus


@pytest.mark.parametrize("case", [
    (70, 3, 9, 200, 3000, 128, True, ()),         # skewed: 3 tiles, list 0
    (40, 2, 12, 150, 2000, 128, False, (3, 5)),   # unprobed, empty lists
    (9, 6, 6, 77, 500, 128, False, (2,)),         # nprobe = nlist
    (1, 4, 7, 300, 900, 128, False, ()),          # one query
    (20, 3, 6, 90, 400, 784, True, (2,)),         # the narrow tile
    (25, 3, 6, 90, 400, 130, True, (4,)),         # the 4-byte path
    (6, 2, 4, 40, 300, 1000, False, ()),          # too wide to stage
    (5, 2, 4, 40, 300, 16, True, ()),             # fewer float4s than lanes
])
@pytest.mark.parametrize("aligned", [True, False])
def test_beam_gather_lists_bit_equal_to_b1(cuda, case, aligned):
    """B1's list-major entry equals B1's gather entry over the candidate
    block lists[probe] bit for bit on every live slot (B1's float4 path
    where D % 4 == 0 and the corpus is 16-byte aligned, its 4-byte path
    otherwise; unaligned cases also take queries 4 bytes off a 16-byte
    boundary, which the wide-D path reads from global memory), is +inf on
    every PAD slot and past each list's length, and holds its plain
    version; its counter moves by one, B1's not at all."""
    from repro_torch.core.ivf import live_lengths
    q, probe, lists, corpus = _lists_case(sum(case[:6]), *case)
    d = corpus.shape[1]
    x, qt = ((torch.as_tensor(corpus, device=cuda),
              torch.as_tensor(q, device=cuda)) if aligned
             else (_unaligned(corpus, cuda), _unaligned(q, cuda)))
    pt, lt = (torch.as_tensor(a, device=cuda) for a in (probe, lists))
    ll = live_lengths(lt)
    b0, l0 = bg_mod.launches, bg_mod.lists_launches
    got = ops.beam_gather_lists_distances(qt, pt, lt, ll, x)
    torch.cuda.synchronize()
    assert (bg_mod.launches, bg_mod.lists_launches) == (b0, l0 + 1)
    cand = lt[pt.long()].reshape(len(q), -1)
    b1 = ops.beam_gather_distances(qt, cand.clamp_min(0).contiguous(), x,
                                   mode="l2")
    live = cand != -1
    assert torch.equal(got[live].view(torch.int32),
                       b1[live].view(torch.int32))
    assert bool(torch.isinf(got[~live]).all())
    want = ops.beam_gather_lists_distances(qt, pt, lt, ll, x, force_ref=True)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got[live], want[live], rtol=2e-4,
                               atol=2e-4 * d)


LISTS_CASES = [
    (70, 3, 9, 200, 3000, 128, True, ()),         # skewed: 3 tiles, list 0
    (40, 2, 12, 150, 2000, 128, False, (3, 5)),   # unprobed, empty lists
    (9, 6, 6, 77, 500, 128, False, (2,)),         # nprobe = nlist
    (1, 4, 7, 300, 900, 128, False, ()),          # one query
    (20, 3, 6, 90, 400, 784, True, (2,)),         # the narrow tile
    (25, 3, 6, 90, 400, 130, True, (4,)),         # the 4-byte path
    (6, 2, 4, 40, 300, 1000, False, ()),          # too wide to stage
    (5, 2, 4, 40, 300, 16, True, ()),             # fewer float4s than lanes
]


@pytest.mark.parametrize("k", [1, 10, 33, 100])
@pytest.mark.parametrize("case", LISTS_CASES)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("integer", [False, True])
def test_beam_gather_lists_topk_bit_equal(cuda, case, aligned, integer, k):
    """B1's fused list-major entry equals ``topk_smallest`` of the matrix
    entry's output bit for bit: every distance, and the column of every
    finite one (k = 33 and 100 keep four chunks of keys a warp, 1 and 10
    one; k = 100 passes the live slots of the 40- and 77-slot lists).  On
    integer rows and queries every sum is exact, so it also equals its
    plain version bit for bit, ties to the lower column; on float ones the
    distances hold the plain version's tolerance.  Its counter moves by one,
    the matrix entry's not at all."""
    from repro_torch.core.ivf import live_lengths
    q, probe, lists, corpus = _lists_case(sum(case[:6]) + k, *case)
    if integer:
        rng = np.random.RandomState(k)
        corpus = rng.randint(-2, 3, corpus.shape).astype(np.float32)
        q = rng.randint(-2, 3, q.shape).astype(np.float32)
    d = corpus.shape[1]
    x, qt = ((torch.as_tensor(corpus, device=cuda),
              torch.as_tensor(q, device=cuda)) if aligned
             else (_unaligned(corpus, cuda), _unaligned(q, cuda)))
    pt, lt = (torch.as_tensor(a, device=cuda) for a in (probe, lists))
    ll = live_lengths(lt)
    l0, t0 = bg_mod.lists_launches, bg_mod.topk_launches
    got_d, got_c = ops.beam_gather_lists_topk(qt, pt, lt, ll, x, k)
    torch.cuda.synchronize()
    assert (bg_mod.lists_launches, bg_mod.topk_launches) == (l0, t0 + 1)
    kk = min(k, probe.shape[1] * lists.shape[1])
    assert got_d.shape == got_c.shape == (len(q), kk)
    mat = ops.beam_gather_lists_distances(qt, pt, lt, ll, x)
    want_d, want_c = topk_smallest(mat, kk)
    fin = torch.isfinite(want_d)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(got_c[fin], want_c[fin])
    plain_d, plain_c = ops.beam_gather_lists_topk(qt, pt, lt, ll, x, k,
                                                  force_ref=True)
    if integer:
        assert torch.equal(got_d.view(torch.int32),
                           plain_d.view(torch.int32))
        assert torch.equal(got_c[fin], plain_c[fin])
    else:
        assert torch.equal(torch.isinf(got_d), torch.isinf(plain_d))
        torch.testing.assert_close(got_d[fin], plain_d[fin], rtol=2e-4,
                                   atol=2e-4 * d)


def test_beam_gather_lists_topk_refuses(cuda):
    """The fused entry keeps at most MAX_TOPK keys a (query, list): past
    that (min(k, M) > 128) and below k = 1 it refuses before any launch;
    the search sends it k <= FUSED_MAX_K only."""
    from repro_torch.core.ivf import live_lengths
    q, probe, lists, corpus = _lists_case(5, 4, 2, 4, 200, 300, 32, False)
    t = [torch.as_tensor(a, device=cuda) for a in (q, probe, lists, corpus)]
    ll = live_lengths(t[2])
    t0 = bg_mod.topk_launches
    for k in (0, bg_mod.MAX_TOPK + 1):
        with pytest.raises(ValueError, match="beam_gather_lists_topk"):
            bg_mod.beam_gather_lists_topk(t[0], t[1], t[2], ll, t[3], k)
    assert bg_mod.topk_launches == t0


def test_ivf_search_on_card_equals_the_b1_route(cuda):
    """``_ivf_search`` on the card (B1's list-major entries: the fused one
    at k = 10 and 50, the matrix one and ``topk_smallest`` at k = 150, past
    FUSED_MAX_K; ids read back from the probe and the lists) returns the
    route they replaced bit for bit: the candidate block lists[probe], B1's
    gather entry, +inf on PAD, the tie-stable top-k and the block's ids; one
    query chunk or many."""
    from repro_torch.core import ivf as ivf_mod
    rng = np.random.RandomState(11)
    x = rng.randn(6000, 64).astype(np.float32)
    cfg = IVFConfig(nlist=40, nprobe=7, metric="l2")
    idx = IVFIndex(cfg, device="cuda")
    idx.train(x)
    idx.build_lists(x)
    corpus = torch.as_tensor(x, device=cuda)
    q = corpus[:300] + 0.05 * torch.randn(300, 64, device=cuda)
    b0, t0 = bg_mod.lists_launches, bg_mod.topk_launches
    for k in (10, 50, 150):
        got_d, got_i = ivf_mod._ivf_search(corpus, q, idx.centroids,
                                           idx.lists, k, cfg.nprobe,
                                           idx.list_len)
        _, probe = flat_search(q, idx.centroids, cfg.nprobe, metric="l2")
        cand = idx.lists[probe.long()].reshape(len(q), -1)
        d = ops.beam_gather_distances(q, cand.clamp_min(0).contiguous(),
                                      corpus, mode="l2")
        d = torch.where(cand != -1, d, float("inf"))
        want_d, sel = topk_smallest(d, k)
        want_i = cand.gather(1, sel)
        want_i = torch.where(torch.isfinite(want_d), want_i,
                             torch.full_like(want_i, -1))
        assert torch.equal(got_d.view(torch.int32),
                           want_d.view(torch.int32))
        assert torch.equal(got_i, want_i)
    assert (bg_mod.lists_launches, bg_mod.topk_launches) == (b0 + 1, t0 + 2)
    whole = ivf_mod._ivf_search(corpus, q, idx.centroids, idx.lists, 10,
                                cfg.nprobe)
    saved, ivf_mod.IVF_BLOCK_BYTES = ivf_mod.IVF_BLOCK_BYTES, 1
    try:
        parts = ivf_mod._ivf_search(corpus, q, idx.centroids, idx.lists, 10,
                                    cfg.nprobe, idx.list_len)
    finally:
        ivf_mod.IVF_BLOCK_BYTES = saved
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nq,n,k", [(1024, 1024, 32), (32, 1024, 65),
                                    (1024, 8192, 40)])
def test_small_corpus_route_equals_fused_entry(cuda, nq, n, k):
    """Where ``flat_search`` takes the matrix route on a small corpus past
    the fused entry's fast k (IVF's coarse probe: Q 1,024 x 1,024
    centroids, k = nprobe = 32), it returns the fused entry's bits."""
    from repro_torch.core.flat import takes_fused
    assert not takes_fused("l2", nq, n, k)
    rng = np.random.RandomState(n + k)
    x = torch.as_tensor(rng.randn(n, 128).astype(np.float32), device=cuda)
    q = torch.as_tensor(rng.randn(nq, 128).astype(np.float32), device=cuda)
    t0, m0 = l2_mod.topk_launches, l2_mod.launches
    got_d, got_i = flat_search(q, x, k, metric="l2")
    assert (l2_mod.topk_launches, l2_mod.launches) == (t0, m0 + 1)
    want_d, want_i = ops.l2_topk(q, x, k, mode="l2")
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(got_i, want_i.to(torch.int32))


def test_sharded_collection_on_card_equals_single(cuda):
    """A sharded, replicated exact collection with every engine on the card
    returns a single collection's hits, through the fan-out threads and
    the collection-level batcher, and launches B5's fused entry."""
    from repro_torch.api import Database, KeywordField, VectorField
    x = gaussian_mixture(4000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(40, 32, n_clusters=15, scale=0.3, seed=2)
    db = Database(device="cuda")
    cols = [db.create_collection(
        name=name, vector=VectorField(dim=32, index="flat"),
        fields=(KeywordField("tag"),), shards=s, replicas=r)
        for name, s, r in (("sharded", 4, 2), ("single", 1, 1))]
    for col in cols:
        col.upsert([f"id-{i}" for i in range(len(x))], x,
                   [{"tag": f"t{i % 5}"} for i in range(len(x))])
    before = l2_mod.topk_launches
    got, want = (c.query(q).top_k(10).run() for c in cols)
    assert [[h.id for h in r] for r in got] == \
        [[h.id for h in r] for r in want]
    singles = [cols[0].query(v).top_k(10).filter(tag="t1").run() for v in q]
    ref_f = [cols[1].query(v).top_k(10).filter(tag="t1").run() for v in q]
    assert [[h.id for h in r] for r in singles] == \
        [[h.id for h in r] for r in ref_f]
    assert l2_mod.topk_launches > before
    assert cols[0]._views[0].replicas[0].device.type == "cuda"
    db.close()


def test_launch_counters_count_every_thread(cuda):
    """A sharded collection's fan-out threads launch one kernel at once:
    every launch is counted (the counters' lock), none lost, with more
    threads than cores and a short switch interval."""
    import sys
    import threading
    corpus, q, ids = _inputs(3, 4, 64, 32, 8)
    args = [torch.as_tensor(a, device=cuda) for a in (q, ids, corpus)]
    threads, per = 32, 40
    before = bg_mod.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            ops.beam_gather_distances(*args) for _ in range(per)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert bg_mod.launches == before + threads * per


@pytest.fixture(scope="module")
def world_one():
    """A single-rank process group with NCCL for the card and gloo for the
    CPU, so that one process holds a mesh on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import torch.distributed as dist
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("mode", ["rows", "dims"])
@pytest.mark.parametrize("case", ["flat_cosine", "flat_l2", "pq", "bq"])
def test_distributed_search_on_card_matches_cpu(cuda, world_one, case, mode,
                                                k):
    """The three makers at world 1 on NCCL return what the same call on the
    CPU with gloo returns: integer-valued inputs, so the ids match exactly,
    ties included; each scan runs its kernel (B5's fused entry, B6, B7)."""
    from repro_torch.distributed import (make_flat_search,
                                         make_hamming_search, make_pq_search)
    from repro_torch.launch.mesh import make_local_mesh
    rng = np.random.RandomState(11)
    n, nq = 20_000, 40
    if case.startswith("flat"):
        x = rng.randint(-4, 5, (n, 32)).astype(np.float32)
        q = rng.randint(-4, 5, (nq, 32)).astype(np.float32)
        make = lambda mesh: make_flat_search(   # noqa: E731
            mesh, k=k, metric=case[5:], dim=32, mode=mode)
        mod, attr = l2_mod, "topk_launches"
    elif case == "pq":
        x = rng.randint(0, 256, (n, 16)).astype(np.uint8)
        q = rng.randint(0, 64, (nq, 16, 256)).astype(np.float32)
        make = lambda mesh: make_pq_search(   # noqa: E731
            mesh, k=k, m_subspaces=16, mode=mode)
        mod, attr = adc_mod, "launches"
    else:
        x = rng.randint(-2 ** 31, 2 ** 31, (n, 8)).astype(np.int32)
        q = rng.randint(-2 ** 31, 2 ** 31, (nq, 8)).astype(np.int32)
        make = lambda mesh: make_hamming_search(   # noqa: E731
            mesh, k=k, words=8, mode=mode)
        mod, attr = hm_mod, "launches"
    out = {}
    for dev in ("cuda", "cpu"):
        fn = make(make_local_mesh(1, 1, device=dev))
        before = getattr(mod, attr)
        d, i = fn(torch.as_tensor(x, device=dev),
                  torch.as_tensor(q, device=dev))
        assert (getattr(mod, attr) > before) == (dev == "cuda")
        out[dev] = (d.cpu(), i.cpu())
    assert out["cuda"][1].dtype == torch.int32
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-4,
                               atol=2e-4)


def test_device_put_batches_on_card(cuda):
    """Each batch lands on the card equal to its arrays, containers kept.
    The copies run on the pipeline's own stream (here held back behind a
    ~0.5 s spin), and the consumer's stream waits on them: a read on the
    consumer's stream right after ``next`` sees the copied values."""
    import threading
    import time

    from repro_torch.data import device_put_batches
    rng = np.random.RandomState(12)
    batches = [{"x": rng.randn(2048, 2048).astype(np.float32),
                "ids": (rng.randint(0, 9, (7,)).astype(np.int64),)}
               for _ in range(3)]
    gate = threading.Event()

    def gated():
        gate.wait(60)
        yield from batches

    it = device_put_batches(gated(), depth=1)
    assert it.stream != torch.cuda.current_stream()
    with torch.cuda.stream(it.stream):
        torch.cuda._sleep(10 ** 9)
    gate.set()
    t0 = time.perf_counter()
    first = next(it)
    got = first["x"].cpu()
    assert time.perf_counter() - t0 > 0.1          # waited behind the spin
    assert torch.equal(got, torch.from_numpy(batches[0]["x"]))
    assert first["x"].device.type == "cuda"
    rest = [first] + list(it)
    assert len(rest) == 3
    for b, g in zip(batches, rest):
        assert torch.equal(g["x"].cpu(), torch.from_numpy(b["x"]))
        assert isinstance(g["ids"], tuple)
        assert torch.equal(g["ids"][0].cpu(), torch.from_numpy(b["ids"][0]))
