"""IVF (inverted-file) index in PyTorch: the port of the JAX package's
``repro.core.ivf``.

k-means coarse quantizer → per-centroid inverted lists padded to a fixed
``max_list`` (PAD slots score +inf) → probe the ``nprobe`` nearest lists.
Search cost drops from O(N) to O(nprobe·N/nlist) with a smooth recall knob.
Composes with PQ: the engine scans reconstructions (IVF-PQ).

k-means seeds from a ``torch.Generator`` (the PQ quantizer's
`_fit_one_subspace`), so trained centroids differ from the JAX package's
``jax.random`` ones: parity is held by loading the JAX centroids
(`IVFIndex.load_state_dict`), the port's own training by recall.

`IVFIndex.build_lists` gives exactly the reference's lists, overflow
included.  The reference places rows in index order, each into the first
list of its (stable) preference order that is not yet full.  Here every row
first takes its nearest list (ties to the lower index); then, round by
round, the earliest row at which a list reaches ``max_list`` closes that
list, and every later row that chose it moves to its nearest list still
open.  Rows before that point are placed as the reference places them, so
each round fixes one more closing: at most ``nlist`` rounds of O(N) work.

`_ivf_search` on the CPU follows the reference step by step (norm-expansion
distances, tie-stable top-k).  On the card the coarse probe is the exact
scan ``flat_search`` over the centroids, and the candidates' distances are
B1's list-major entries (diff-square-sum, bit for bit B1 ``beam_gather``
over ``lists[probe]``), which read each probed list once a tile of the
queries that probe it and take the lists' live lengths
(``IVFIndex.list_len``) in place of the (Q, nprobe·max_list) block of
candidate ids.  Where the top-k is at most ``FUSED_MAX_K`` (100,
`lists_take_fused`) one launch of the fused entry ``beam_gather_lists_topk``
keeps each (query, list)'s k smallest and one selection merges them: the
(Q, nprobe·max_list) distances are never written.  Past it the matrix
entry ``beam_gather_lists`` writes them and ``topk_smallest`` selects; the
two give the same bits.  A kept slot's id is read back from the probe and
the lists.  So ids match the CPU's except at near-ties and distances
within B1's tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.beam_gather import MAX_LIST_SLOTS
from ..kernels.ref import PAD, topk_smallest
from .distances import normalize
from .flat import FUSED_MAX_K, flat_search
from .pq import _fit_one_subspace, _sq_dists

#: bytes of one query chunk's candidate block: the (Q, C) distances on the
#: card, the (Q, C, D) gathered rows of the plain form
IVF_BLOCK_BYTES = 1 << 28
#: rows per block of build_lists' first assignment: bounds the (rows,
#: nlist) distance block
ASSIGN_CHUNK = 1 << 16


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    nlist: int = 64           # coarse centroids
    nprobe: int = 8           # lists probed per query
    metric: str = "cosine"    # cosine (normalize + dot) | l2
    kmeans_iters: int = 20
    list_slack: float = 1.5   # max_list = slack * N/nlist (overflow drops
    #                           to the next-nearest list, never silently)


class IVFIndex:
    """Coarse-quantized inverted-file index; centroids and lists live on
    ``device``."""

    def __init__(self, config: IVFConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.centroids: Optional[torch.Tensor] = None   # (nlist, D) float32
        self.lists: Optional[torch.Tensor] = None       # (nlist, max_list) int32
        self.list_len: Optional[torch.Tensor] = None    # (nlist,) int32
        self.list_sizes: Optional[np.ndarray] = None

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def prep(self, x) -> torch.Tensor:
        """Rows on the device in the index's space: unit rows for cosine,
        float32 otherwise."""
        x = torch.as_tensor(x).to(self.device)
        return normalize(x) if self.config.metric == "cosine" else x.float()

    # ------------------------------------------------------------- build
    def train(self, vectors, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.centroids = _fit_one_subspace(gen, self.prep(vectors),
                                           self.config.nlist,
                                           self.config.kmeans_iters)

    def build_lists(self, vectors) -> None:
        """Assign every vector to its nearest centroid with room; pad lists.
        The same lists as the reference's loop (see the module doc)."""
        cfg = self.config
        x = self.prep(vectors)
        n, nlist = x.shape[0], cfg.nlist
        max_list = int(cfg.list_slack * n / nlist) + 1
        rows = torch.arange(n, device=self.device)
        assign = torch.cat([_sq_dists(x[lo: lo + ASSIGN_CHUNK],
                                      self.centroids).argmin(1)
                            for lo in range(0, n, ASSIGN_CHUNK)]) \
            if n else rows.clone()
        closed = torch.zeros(nlist, dtype=torch.bool, device=self.device)
        while True:
            placed = assign >= 0
            counts = torch.bincount(assign[placed], minlength=nlist)
            full = (counts >= max_list) & ~closed
            if not bool(full.any()):
                break
            # rows grouped by list in row order (dropped rows, -1, first):
            # a list's max_list-th member is the row that fills it
            order = torch.sort(assign, stable=True).indices
            start = (n - int(placed.sum())) + torch.cumsum(counts, 0) - counts
            lists_full = full.nonzero()[:, 0]
            fill = order[start[lists_full] + max_list - 1]
            j = int(fill.argmin())
            c, t = lists_full[j], fill[j]
            closed[c] = True
            # every list closed so far closed at or before row t, so a
            # later row's open lists are the unclosed ones
            movers = ((assign == c) & (rows > t)).nonzero()[:, 0]
            if len(movers):
                d = _sq_dists(x[movers], self.centroids)
                d = d.masked_fill(closed[None, :], float("inf"))
                best = d.argmin(1)
                # a row that finds every list full is dropped, as in the
                # reference's loop
                assign[movers] = torch.where(closed.all(), -1, best)
        out = torch.full((nlist, max_list), PAD, dtype=torch.int32,
                         device=self.device)
        order = torch.sort(assign, stable=True).indices
        order = order[assign[order] >= 0]
        lst = assign[order]
        start = torch.cumsum(counts, 0) - counts
        out[lst, rows[: len(order)] - start[lst]] = order.to(torch.int32)
        self.lists = out
        self.list_len = live_lengths(out)
        self.list_sizes = counts.cpu().numpy()

    # ------------------------------------------------------------ search
    def search(self, corpus, queries, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact distances within the probed lists.  corpus: the raw (N, D)
        vectors (or reconstructions for IVF-PQ); `search_prepped` takes
        rows already in the index's space (the engine caches them)."""
        return self.search_prepped(self.prep(corpus), queries, k)

    def search_prepped(self, corpus: torch.Tensor, queries, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _ivf_search(corpus, self.prep(queries), self.centroids,
                           self.lists, k, self.config.nprobe, self.list_len)

    def state_dict(self):
        return {"centroids": self.centroids.cpu().numpy(),
                "lists": self.lists.cpu().numpy()}

    def load_state_dict(self, state):
        self.centroids = torch.as_tensor(
            np.array(state["centroids"], dtype=np.float32)).to(self.device)
        lists = np.array(state["lists"], dtype=np.int32)
        self.lists = torch.as_tensor(lists).to(self.device)
        # list_len and list_sizes are derived state and are not serialized
        self.list_len = live_lengths(self.lists)
        self.list_sizes = (lists != PAD).sum(axis=1)


def live_lengths(lists: torch.Tensor) -> torch.Tensor:
    """(nlist,) int32 on the lists' device: one past each list's last
    non-PAD slot (its size, for the packed lists `build_lists` makes).  The
    list-major kernel reads no slot at or past it."""
    pos = torch.arange(1, lists.shape[1] + 1, dtype=torch.int32,
                       device=lists.device)
    return torch.where(lists != PAD, pos, 0).amax(1)


def lists_take_fused(k: int, c: int) -> bool:
    """Whether the card's IVF search of top-k over c candidates a query
    takes the fused entry ``beam_gather_lists_topk`` (else the matrix entry
    ``beam_gather_lists`` and ``topk_smallest``): min(k, c) up to
    ``FUSED_MAX_K``, the exact scan's limit too."""
    return 0 < min(k, c) <= FUSED_MAX_K


def list_candidates(q: torch.Tensor, probe: torch.Tensor,
                    lists: torch.Tensor, list_len: torch.Tensor,
                    corpus: torch.Tensor, k: int, fused: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query chunk of the card's search over its probed lists: the k
    smallest candidate distances (+inf on PAD slots and past each list's
    live length) and their columns of the (Q, nprobe·max_list) candidate
    block, by the fused entry or by the matrix entry and ``topk_smallest``
    (the same bits; CPU tensors take the plain versions)."""
    if fused:
        return ops.beam_gather_lists_topk(q, probe, lists, list_len, corpus,
                                          k)
    d = ops.beam_gather_lists_distances(q, probe, lists, list_len, corpus)
    return topk_smallest(d, k)


def hit_ids(dk: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The search's ids: -1 where the distance is +inf (a PAD slot, a slot
    past its list's length, or no candidate left)."""
    return torch.where(torch.isfinite(dk), ids, torch.full_like(ids, -1))


def _slot_ids(lists: torch.Tensor, probe: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """The ids at columns ``idx`` (Q, k) of the (Q, nprobe·max_list)
    candidate block ``lists[probe].reshape(Q, -1)``, without the block:
    lists[probe[q, idx // max_list], idx % max_list]."""
    m = lists.shape[1]
    return lists[probe.gather(1, idx // m).long(), idx % m]


def _ivf_search(corpus: torch.Tensor, queries: torch.Tensor,
                centroids: torch.Tensor, lists: torch.Tensor, k: int,
                nprobe: int, list_len: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances (Q, min(k, C)) ascending, int32 ids; -1 where +inf) of
    each query over the candidates of its ``nprobe`` nearest lists, C =
    nprobe·max_list.  All tensors on one device; the card takes the
    kernels, the CPU the reference's arithmetic.  ``list_len``: the lists'
    `live_lengths` (derived here when None)."""
    q = queries
    nq = q.shape[0]
    card = corpus.device.type == "cuda"
    # 1. nearest nprobe centroids per query, ties to the lower index: the
    # card's exact scan, the CPU the reference's unclamped norm expansion
    if card:
        _, probe = flat_search(q, centroids, nprobe, metric="l2")
    else:
        dc = ((q * q).sum(1)[:, None] + (centroids * centroids).sum(1)[None, :]
              - 2.0 * (q @ centroids.T))
        _, probe = topk_smallest(dc, nprobe)
    # 2. candidates: (Q, nprobe * max_list) slots, their ids built as a
    # block on the CPU only
    c = nprobe * lists.shape[1]
    kk = min(k, c)
    if card:
        if c > MAX_LIST_SLOTS:
            raise ValueError(
                f"IVF search: {c} candidates a query (nprobe {nprobe} x "
                f"max_list {lists.shape[1]}) exceed beam_gather_lists's "
                f"int32 offsets ({MAX_LIST_SLOTS}); lower nprobe or raise "
                f"nlist")
        if list_len is None:
            list_len = live_lengths(lists)
    else:
        cand = lists[probe].reshape(nq, -1)
    # 3. exact distances to the candidates, a chunk of queries at a time
    # (on the card the fused entry holds nprobe lists of min(kk, max_list)
    # keys a query, the matrix entry c distances)
    fused = card and lists_take_fused(k, c)
    if fused:
        row_bytes = probe.shape[1] * min(kk, lists.shape[1]) * 8
    else:
        row_bytes = c * 4 * (1 if card else corpus.shape[1])
    step = max(1, min(IVF_BLOCK_BYTES // max(row_bytes, 1),
                      MAX_LIST_SLOTS // max(c, 1)))
    out_d, out_i = [], []
    for lo in range(0, nq, step):
        qc = q[lo: lo + step]
        if card:
            pc = probe[lo: lo + step]
            dk, idx = list_candidates(qc, pc, lists, list_len, corpus, kk,
                                      fused)
            ids = _slot_ids(lists, pc, idx)
        else:
            cc = cand[lo: lo + step]
            vecs = corpus[cc.clamp_min(0).long()]            # (q, C, D)
            d = ((qc * qc).sum(1)[:, None] + (vecs * vecs).sum(-1)
                 - 2.0 * torch.einsum("qd,qcd->qc", qc, vecs))
            d = torch.where(cc != PAD, d, float("inf"))
            dk, idx = topk_smallest(d, kk)
            ids = cc.gather(1, idx)
        out_d.append(dk)
        out_i.append(hit_ids(dk, ids))
    if not out_d:
        return (q.new_zeros((0, kk)),
                torch.zeros((0, kk), dtype=torch.int32, device=q.device))
    return torch.cat(out_d), torch.cat(out_i)
