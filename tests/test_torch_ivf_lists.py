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
matrix route) is checked by shape.  The CUDA kernel itself runs only on a
card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.beam_gather import beam_gather_kernel
from repro_torch.core import IVFConfig, IVFIndex
from repro_torch.core import flat as flat_mod
from repro_torch.core.ivf import PAD, _slot_ids, live_lengths
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


def _case(name):
    nq, nprobe, nlist, m, n, d, skew, empty, pad_inside = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    corpus = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
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


@pytest.mark.parametrize("tq", [8, 32])
@pytest.mark.parametrize("name", ["skewed", "unprobed_and_empty",
                                  "nprobe_is_nlist", "one_query"])
def test_schedule_covers_every_entry_once(name, tq):
    """``list_tiles`` and the kernel's block search (``tile_of_block``):
    every (query, rank) entry lands in exactly one block, whose list is the
    entry's probed list, a block takes at most tq entries of one list,
    blocks past the last tile take none, and the grid bounds the tiles."""
    _, probe, lists, _ = _case(name)
    nlist = lists.shape[0]
    p = torch.as_tensor(probe)
    entries, starts, tile_end = bg_mod.list_tiles(p, nlist, tq)
    assert entries.dtype == starts.dtype == tile_end.dtype == torch.int32
    n_blocks = bg_mod.list_blocks(p.numel(), nlist, tq)
    assert int(tile_end[-1]) <= n_blocks
    lst, first, count = bg_mod.tile_of_block(starts, tile_end, tq, n_blocks)
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
