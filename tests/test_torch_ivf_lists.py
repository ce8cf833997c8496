"""B1's list-major entry (``beam_gather_lists``) as the IVF search runs it.

The plain version is held exactly to B1's plain version over the candidate
block ``lists[probe]`` with PAD at +inf, and to the JAX package's B1 oracle
and its Pallas kernel (interpret mode) on the live slots, on seeded numpy
inputs: skewed probes (one list probed by more queries than a tile), lists
probed by none, empty lists, nprobe = nlist, Q = 1, D = 128, 784 and 130.
The kernel's schedule (``list_tiles``, ``tile_of_block``) covers every
(query, rank) entry once; the search's id recovery from (probe, idx // M,
idx % M) equals the candidate block's; ``IVFIndex.list_len`` is derived,
never serialized; ``flat_search``'s dispatch on the card (fused entry or
matrix route) is checked by shape.  The fused entry's plain version
(``beam_gather_lists_topk``: each query's k smallest candidates without the
(Q, P * M) distances on the card) is held to an independent stable sort of
the candidate block's distances on every case, at k = 1, 10, 100 and past
the live slots, on float and on tied integer inputs; its columns map
through ``_slot_ids`` to the block's ids, +inf to id -1; and the search's
dispatch between the two entries (``lists_take_fused``) is checked by
shape.  The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.beam_gather import beam_gather_kernel
from repro_torch.core import IVFConfig, IVFIndex
from repro_torch.core import flat as flat_mod
from repro_torch.core.ivf import (PAD, _slot_ids, hit_ids, list_candidates,
                                  lists_take_fused, live_lengths)
from repro_torch.kernels import beam_gather as bg_mod
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)


def _lists(rng, nlist, m, n, empty=(), pad_inside=False):
    """(nlist, m) int32 lists packed from the front with PAD after each
    list's size; ``empty`` lists hold nothing; with ``pad_inside`` a PAD
    slot sits inside some live lists (a hand-made state)."""
    lists = np.full((nlist, m), PAD, dtype=np.int32)
    for lst in range(nlist):
        size = 0 if lst in empty else rng.randint(1, m + 1)
        lists[lst, :size] = rng.randint(0, n, size)
        if pad_inside and size > 3:
            lists[lst, size // 2] = PAD
    return lists


def _probe(rng, nq, nprobe, nlist, skew):
    """(nq, nprobe) distinct lists a query; ``skew``: every query probes
    list 0 first (more queries than a tile on one list); lists past
    ``nlist - 2`` are probed by none unless nprobe needs them."""
    probe = np.empty((nq, nprobe), dtype=np.int32)
    pool = nlist if nprobe > nlist - 2 else nlist - 2
    for i in range(nq):
        perm = rng.permutation(pool)
        if skew:
            perm = np.concatenate([[0], perm[perm != 0]])
        probe[i] = perm[:nprobe]
    return probe


# (nq, nprobe, nlist, m, n, d, skew, empty lists, PAD inside live lengths)
CASES = {
    "skewed": (70, 3, 9, 40, 300, 128, True, (), False),
    "unprobed_and_empty": (20, 2, 9, 33, 200, 128, False, (3, 5), False),
    "nprobe_is_nlist": (9, 5, 5, 21, 120, 128, False, (2,), False),
    "one_query": (1, 4, 7, 50, 200, 128, False, (), False),
    "d784": (12, 3, 6, 17, 150, 784, True, (1,), False),
    "d130": (15, 3, 6, 29, 150, 130, True, (4,), True),
    "pad_inside": (10, 3, 6, 25, 100, 16, False, (0,), True),
}


def _case(name, integer=False):
    """A case's (q, probe, lists, corpus); ``integer``: small integer rows
    and queries, so that distances tie often and every sum is exact."""
    nq, nprobe, nlist, m, n, d, skew, empty, pad_inside = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    corpus = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
    if integer:
        corpus = rng.randint(-2, 3, (n, d)).astype(np.float32)
        q = rng.randint(-2, 3, (nq, d)).astype(np.float32)
    lists = _lists(rng, nlist, m, n, empty, pad_inside)
    probe = _probe(rng, nq, nprobe, nlist, skew)
    return q, probe, lists, corpus


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_b1_over_the_candidate_block(name):
    """The plain version is B1's plain version over ``lists[probe]`` with
    PAD at +inf, bit for bit, and the JAX package's B1 oracle and Pallas
    kernel on the live slots."""
    q, probe, lists, corpus = _case(name)
    nq, nprobe = probe.shape
    t = [torch.as_tensor(a) for a in (q, probe, lists, corpus)]
    list_len = live_lengths(t[2])
    got = ops.beam_gather_lists_distances(t[0], t[1], t[2], list_len, t[3])
    assert got.shape == (nq, nprobe * lists.shape[1])
    cand = lists[probe].reshape(nq, -1)
    b1 = ref.beam_gather_l2_ref(t[0], torch.as_tensor(cand).clamp_min(0),
                                t[3])
    want = torch.where(torch.as_tensor(cand) != PAD, b1, float("inf"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    live = cand != PAD
    assert np.isinf(got.numpy()[~live]).all()
    for i in range(nq):
        ids = cand[i][live[i]]
        jwant = jref.beam_gather_l2_ref(jnp.asarray(q[i]), jnp.asarray(ids),
                                        jnp.asarray(corpus))
        np.testing.assert_allclose(got.numpy()[i][live[i]],
                                   np.asarray(jwant), **TOL)
    ids = cand[0][live[0]]
    pallas = beam_gather_kernel(jnp.asarray(q[0]), jnp.asarray(ids),
                                jnp.asarray(corpus), mode="l2",
                                tb=min(32, len(ids)), interpret=True)
    np.testing.assert_allclose(got.numpy()[0][live[0]], np.asarray(pallas),
                               **TOL)


def test_plain_honours_list_len():
    """Slots at or past a list's ``list_len`` are +inf even where they hold
    an id: the kernel reads no row there."""
    q, probe, lists, corpus = _case("skewed")
    t = [torch.as_tensor(a) for a in (q, probe, lists, corpus)]
    full = live_lengths(t[2])
    cut = (full // 2).to(torch.int32)
    got = ref.beam_gather_lists_ref(t[0], t[1], t[2], cut, t[3])
    want = ref.beam_gather_lists_ref(t[0], t[1], t[2], full, t[3])
    m = lists.shape[1]
    r = torch.arange(m).repeat(probe.shape[1])
    past = r[None, :] >= cut[t[1].long()].repeat_interleave(m, dim=1)
    assert torch.isinf(got[past]).all()
    assert torch.equal(got[~past], want[~past])


@pytest.mark.parametrize("longest_first", [False, True])
@pytest.mark.parametrize("tq", [8, 32])
@pytest.mark.parametrize("name", ["skewed", "unprobed_and_empty",
                                  "nprobe_is_nlist", "one_query"])
def test_schedule_covers_every_entry_once(name, tq, longest_first):
    """``list_tiles`` and the kernels' block search (``tile_of_block``),
    the lists by id (the matrix entry) or longest first (the fused entry,
    ``longest_first``): every (query, rank) entry lands in exactly one
    block, whose list is the entry's probed list, a block takes at most tq
    entries of one list, blocks past the last tile take none, the grid
    bounds the tiles, and in the fused order no list's tiles start before
    a longer list's."""
    _, probe, lists, _ = _case(name)
    nlist = lists.shape[0]
    p = torch.as_tensor(probe)
    list_len = live_lengths(torch.as_tensor(lists))
    order = bg_mod.longest_first(list_len) if longest_first else None
    entries, starts, tile_end = bg_mod.list_tiles(p, nlist, tq, order)
    assert entries.dtype == starts.dtype == tile_end.dtype == torch.int32
    n_blocks = bg_mod.list_blocks(p.numel(), nlist, tq)
    assert int(tile_end[-1]) <= n_blocks
    lst, first, count = bg_mod.tile_of_block(starts, tile_end, tq, n_blocks,
                                             order)
    if longest_first:
        assert order.dtype == torch.int32
        assert sorted(order.tolist()) == list(range(nlist))
        live_len = list_len[lst[lst < nlist]]
        assert bool((live_len[1:] <= live_len[:-1]).all())
    assert bool((count <= tq).all()) and bool((count[lst == nlist] == 0).all())
    assert bool((count[lst < nlist] > 0).all())
    seen = np.zeros(p.numel(), dtype=int)
    flat = probe.reshape(-1)
    for b in range(n_blocks):
        for e in entries[first[b]: first[b] + count[b]].numpy():
            seen[e] += 1
            assert flat[e] == int(lst[b])
    assert (seen == 1).all()
    # within a list the entries keep the probe's order (a stable sort)
    for lst_id in range(nlist):
        ent = entries[starts[lst_id]: starts[lst_id + 1]].numpy()
        assert (np.diff(ent) > 0).all()


def test_slot_ids_equal_the_candidate_block():
    """The search reads a kept slot's id as lists[probe[q, idx // M],
    idx % M]: the candidate block's ``gather`` on the same slots."""
    q, probe, lists, _ = _case("unprobed_and_empty")
    rng = np.random.RandomState(3)
    nq, c = probe.shape[0], probe.shape[1] * lists.shape[1]
    idx = torch.as_tensor(rng.randint(0, c, (nq, 11)))
    cand = torch.as_tensor(lists)[torch.as_tensor(probe).long()] \
        .reshape(nq, -1)
    got = _slot_ids(torch.as_tensor(lists), torch.as_tensor(probe), idx)
    assert got.dtype == torch.int32
    assert torch.equal(got, cand.gather(1, idx))


def test_list_len_is_derived_state():
    """``list_len`` is one past each list's last live slot (its size for
    built lists), set by build_lists and load_state_dict, int32, and never
    serialized."""
    rng = np.random.RandomState(6)
    x = rng.randn(400, 8).astype(np.float32)
    idx = IVFIndex(IVFConfig(nlist=8, metric="l2"), device="cpu")
    idx.train(x)
    idx.build_lists(x)
    assert idx.list_len.dtype == torch.int32
    np.testing.assert_array_equal(idx.list_len.numpy(), idx.list_sizes)
    state = idx.state_dict()
    assert sorted(state) == ["centroids", "lists"]
    lists = state["lists"].copy()
    lists[0, : 3] = PAD                      # a hand-made state: PAD first
    lists[1, :] = PAD
    back = IVFIndex(IVFConfig(nlist=8, metric="l2"), device="cpu")
    back.load_state_dict({"centroids": state["centroids"], "lists": lists})
    want = [(np.nonzero(r != PAD)[0].max() + 1) if (r != PAD).any() else 0
            for r in lists]
    np.testing.assert_array_equal(back.list_len.numpy(), want)
    assert sorted(back.state_dict()) == ["centroids", "lists"]


def test_cpu_dispatch_takes_the_plain_version():
    q, probe, lists, corpus = _case("one_query")
    t = [torch.as_tensor(a) for a in (q, probe, lists, corpus)]
    before = bg_mod.lists_launches
    got = ops.beam_gather_lists_distances(t[0], t[1], t[2],
                                          live_lengths(t[2]), t[3])
    assert bg_mod.lists_launches == before
    want = ops.beam_gather_lists_distances(t[0], t[1], t[2],
                                           live_lengths(t[2]), t[3],
                                           force_ref=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bg_mod.beam_gather_lists(t[0], t[1], t[2], live_lengths(t[2]), t[3])


@pytest.mark.parametrize("nq,n,k,fused", [
    (1024, 1024, 32, False),        # IVF's coarse probe: the matrix route
    (1024, 1_000_000, 10, True),    # E's exact batch
    (1024, 250_000, 10, True),      # one of H's four shards
    (1024, 1_000_000, 64, True),    # past the fast k, a large corpus
    (1024, 8192, 16, True),
    (1024, 8192, 17, False),
    (1024, 8193, 17, True),
    (1024, 65536, 17, True),        # one flat-route chunk: fused wins
    (32, 65536, 65, True),
    (32, 16960, 10, True),          # the batcher's bucket, the last chunk
    (32, 1024, 64, True),
    (32, 1024, 65, False),
    (33, 1024, 17, False),
    (1024, 8192, 40, False),        # a quantized collection's delta scan
    (1024, 1_000_000, 101, False),  # past FUSED_MAX_K
])
def test_card_dispatch_by_shape(nq, n, k, fused):
    """On the card a scan takes the fused entry unless k passes
    FUSED_MAX_K, or the corpus fits one matrix (MATRIX_MAX_N) and k passes
    the fused entry's fast k; both routes return the same bits
    (tests/test_torch_cuda.py)."""
    assert flat_mod.takes_fused("l2", nq, n, k) is fused
    assert flat_mod.takes_fused("hamming", nq, n, k) is False


def _stable_topk(d, k):
    """The k smallest of each row of d (Q, C) by a stable sort in numpy,
    ties to the lower column: (values, columns), independent of
    ``topk_smallest``'s 64-bit keys."""
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), order


# k = 1, 10, 100, and past every list's live slots (the longest list a
# case holds is at most M < 1,000)
TOPK_KS = (1, 10, 100, 1000)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_topk_plain_equals_the_candidate_block_sorted(name, k, integer):
    """The fused entry's plain version is the k smallest of the matrix
    entry's candidate distances (B1's plain version over lists[probe], +inf
    on PAD and past list_len), by a stable sort: every distance bit for bit,
    and the column of every finite one, ties to the lower column.  Past the
    live slots the rest are +inf."""
    q, probe, lists, corpus = _case(name, integer)
    t = [torch.as_tensor(a) for a in (q, probe, lists, corpus)]
    list_len = live_lengths(t[2])
    got_d, got_c = ops.beam_gather_lists_topk(t[0], t[1], t[2], list_len,
                                              t[3], k)
    c = probe.shape[1] * lists.shape[1]
    assert got_d.shape == got_c.shape == (len(q), min(k, c))
    assert got_c.dtype == torch.int64
    mat = ref.beam_gather_lists_ref(t[0], t[1], t[2], list_len, t[3])
    want_d, want_c = _stable_topk(mat.numpy(), min(k, c))
    assert np.array_equal(got_d.numpy().view(np.int32),
                          want_d.view(np.int32))
    finite = np.isfinite(want_d)
    assert np.array_equal(got_c.numpy()[finite], want_c[finite])
    if k == TOPK_KS[-1]:
        assert not finite.all()
    if integer:
        # ties: equal distances in one row come in column order
        gd, gc = got_d.numpy(), got_c.numpy()
        same = (gd[:, 1:] == gd[:, :-1]) & np.isfinite(gd[:, 1:])
        assert (gc[:, 1:][same] > gc[:, :-1][same]).all()
        assert same.any() or k == 1 or name == "d784"


@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("name", ["skewed", "unprobed_and_empty", "d130",
                                  "pad_inside"])
def test_topk_columns_map_to_the_block_ids(name, k):
    """The fused entry's columns map through ``_slot_ids`` to the ids the
    candidate block holds at them, and ``hit_ids`` gives -1 exactly where
    the distance is +inf; both entries (``list_candidates`` fused or not)
    give the same distances and the same hits."""
    q, probe, lists, corpus = _case(name, integer=True)
    t = [torch.as_tensor(a) for a in (q, probe, lists, corpus)]
    list_len = live_lengths(t[2])
    nq = len(q)
    kk = min(k, probe.shape[1] * lists.shape[1])
    block = t[2][t[1].long()].reshape(nq, -1)
    hits = {}
    for fused in (True, False):
        dk, cols = list_candidates(t[0], t[1], t[2], list_len, t[3], kk,
                                   fused)
        ids = _slot_ids(t[2], t[1], cols)
        assert torch.equal(ids, block.gather(1, cols))
        got = hit_ids(dk, ids)
        assert torch.equal(got == -1, torch.isinf(dk))
        assert bool((got[torch.isfinite(dk)] >= 0).all())
        hits[fused] = (dk, got)
    assert torch.equal(hits[True][0].view(torch.int32),
                       hits[False][0].view(torch.int32))
    assert torch.equal(hits[True][1], hits[False][1])


def test_topk_cpu_takes_the_plain_version_and_refuses():
    """On CPU tensors the fused entry takes its plain version (no launch);
    the wrapper itself refuses k below 1 and a list's min(k, M) over
    MAX_TOPK before it looks at the tensors, and takes CUDA tensors
    only."""
    q, probe, lists, corpus = _case("one_query")
    t = [torch.as_tensor(a) for a in (q, probe, lists, corpus)]
    ll = live_lengths(t[2])
    before = bg_mod.topk_launches
    got = ops.beam_gather_lists_topk(t[0], t[1], t[2], ll, t[3], 10)
    assert bg_mod.topk_launches == before
    want = ops.beam_gather_lists_topk(t[0], t[1], t[2], ll, t[3], 10,
                                      force_ref=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bg_mod.beam_gather_lists_topk(t[0], t[1], t[2], ll, t[3], 10)
    # lists padded past MAX_TOPK slots: the same live slots, wider rows
    wide = torch.nn.functional.pad(
        t[2], (0, bg_mod.MAX_TOPK + 1 - t[2].shape[1]), value=PAD)
    for lst, k in ((t[2], 0), (t[2], -1), (wide, bg_mod.MAX_TOPK + 1)):
        with pytest.raises(ValueError, match="keys a list"):
            bg_mod.beam_gather_lists_topk(t[0], t[1], lst, ll, t[3], k)
    assert bg_mod.topk_launches == before


@pytest.mark.parametrize("k,c,fused", [
    (10, 32 * 1465, True),       # phase G: k = 10 over nprobe 32 x 1,465
    (1, 46880, True),
    (100, 46880, True),          # FUSED_MAX_K
    (101, 46880, False),         # past it: the matrix entry + topk_smallest
    (1000, 46880, False),        # E's k = 1,000 through an IVF collection
    (150, 1582, False),
    (500, 60, True),             # k past every candidate: kk = c = 60
    (500, 101, False),
    (0, 46880, False),
])
def test_ivf_card_dispatch_by_k(k, c, fused):
    """On the card the IVF search takes the fused entry where its top-k,
    min(k, C), is at most FUSED_MAX_K, else the matrix entry and
    ``topk_smallest``; both give the same bits (tests/test_torch_cuda.py)."""
    assert lists_take_fused(k, c) is fused
    assert lists_take_fused(k, c) is (0 < min(k, c) <= flat_mod.FUSED_MAX_K)
