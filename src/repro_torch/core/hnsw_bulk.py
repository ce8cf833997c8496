"""Device-parallel bulk HNSW construction in PyTorch (the default builder).

The port of the JAX package's ``repro.core.hnsw_bulk``: the same phases, the
same numpy random stream (levels, upper links, random candidates, k-means
sample), the same stable-sort tie rules, so a build that draws no k-means
centroids gives the JAX package's graph.

  * **Vectorized Alg-4 prune** (`_prune_batch`): SELECT-NEIGHBORS-HEURISTIC
    for a whole batch — candidates sorted by distance, the candidate×candidate
    matrix from the ``pair_gather`` CUDA kernel (kernels/ops.py), and a masked
    walk over the C candidate slots keeping "closer to q than to every
    selected neighbour", with keepPruned fill.
  * **Deterministic scatter/cap symmetrize** (`_merge_cap`): existing,
    forward and reverse edges as one list, deduplicated by (target, source),
    ranked per target by (priority, distance, source) with composed stable
    sorts, scattered back capped at M.
  * **Level-wise batched inserts** (`_bulk_level`): exact-kNN bootstrap, then
    batched wide-beam descents (hnsw_search.search, on the ``beam_gather``
    kernel) over the frozen prefix plus an intra-batch kNN block.
  * **Two-phase coarse mode** (`_bulk_coarse`): k-means → exact kNN of each
    node against the union of its two nearest clusters → one global prune +
    symmetrize → the boundary nodes re-linked through batched beam searches.

Exact kNN runs on the build's device (`knn_ids_dists` on torch tensors);
only the small per-node loops (upper-layer links, connectivity repair) stay
on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import gathered_dists
from .flat import topk_smallest
from .hnsw_build import (PAD, HNSWConfig, PackedHNSW, ProgressFn, bulk_build,
                         knn_ids_dists, preprocess_vectors)
from .hnsw_search import HNSWGraph
from .hnsw_search import search as beam_search
from .pq import _fit_one_subspace

logger = logging.getLogger(__name__)

INF = float("inf")

# nodes pruned per call: rows are independent, so the chunk changes no
# result; 4096 keeps the per-slot walk's launches few on a card
PRUNE_CHUNK = 4096
MIN_DEVICE_N = 32        # below this the numpy reference builder is used
STITCH_EF = 64           # beam width cap for cross-cluster stitching
KMEANS_ITERS = 8
ROW_CHUNK = 65536        # rows per block of the row-wise distance helpers


# ---------------------------------------------------------------------------
# vectorized Alg-4 SELECT-NEIGHBORS-HEURISTIC
# ---------------------------------------------------------------------------

def _prune_batch(corpus: torch.Tensor, q_ids: torch.Tensor,
                 cand_ids: torch.Tensor, cand_d: torch.Tensor, *, m: int,
                 mode: str, keep_pruned: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched diversification prune: (B, C) candidates -> (B, m) selected.

    Candidate j survives iff it is closer to the query than to every
    already-selected neighbour (the paper's Alg 4), evaluated as a masked
    walk over the distance-sorted candidate slots.  PAD / self / duplicate /
    out-of-range candidates are masked out first.  Returns (ids PAD-padded
    int32, raw scores inf-padded, slot priority), in selection order.
    """
    b, c = cand_ids.shape
    n = corpus.shape[0]
    dev = corpus.device
    cand_ids = cand_ids.to(torch.int32)

    invalid = (cand_ids < 0) | (cand_ids >= n) \
        | (cand_ids == q_ids[:, None].to(torch.int32))
    # duplicate candidates: cluster ids (invalid -> sentinel n) with a
    # stable sort, flag repeats, scatter the flags back to original slots
    ids_key = torch.where(invalid, n, cand_ids)
    sid, o_id = torch.sort(ids_key, dim=1, stable=True)
    dup_s = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                       (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] < n)], 1)
    invalid = invalid | torch.zeros_like(invalid).scatter(1, o_id, dup_s)

    d = torch.where(invalid, INF, cand_d.float())
    cd, o_d = torch.sort(d, dim=1, stable=True)          # ties keep order
    cid = cand_ids.gather(1, o_d)
    valid = torch.isfinite(cd)

    safe = torch.where(valid, cid, 0)
    pair = ops.pair_gather_distances(safe, corpus, mode=mode)   # (B, C, C)

    sel = torch.zeros((b, c), dtype=torch.bool, device=dev)
    nsel = torch.zeros((b,), dtype=torch.int32, device=dev)
    for j in range(c):
        dmin = torch.where(sel, pair[:, j, :], INF).amin(1)
        ok = valid[:, j] & (nsel < m) & ((nsel == 0) | (cd[:, j] < dmin))
        sel[:, j] = ok
        nsel += ok.to(torch.int32)

    # final order: selected (already distance-sorted) first, then — with
    # keepPruned — the pruned survivors by distance, invalid slots last
    idx = torch.arange(c, device=dev)[None, :].expand(b, c)
    if keep_pruned:
        key = torch.where(sel, idx, torch.where(valid, c + idx, 2 * c + idx))
        limit = torch.clamp_max(valid.sum(1), m)
    else:
        key = torch.where(sel, idx, 2 * c + idx)
        limit = torch.clamp_max(nsel, m)
    o_f = torch.argsort(key, dim=1, stable=True)
    fid = cid.gather(1, o_f)[:, :m]
    fd = cd.gather(1, o_f)[:, :m]
    pos = torch.arange(m, device=dev)[None, :]
    pos_ok = pos < limit[:, None]
    # slot priority: 0 = heuristically selected (diverse — must survive
    # later degree capping), 1 = keepPruned fill (nearest, replaceable)
    pri = (pos >= nsel[:, None]).to(torch.int32)
    return (torch.where(pos_ok, fid, PAD).to(torch.int32),
            torch.where(pos_ok, fd, INF),
            torch.where(pos_ok, pri, 1))


def _prune_chunks(corpus: torch.Tensor, q_ids: torch.Tensor,
                  cand_ids: torch.Tensor, cand_d: torch.Tensor, *, m: int,
                  mode: str, keep_pruned: bool, chunk: int = PRUNE_CHUNK
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run `_prune_batch` over row chunks (bounds the (B, C, C) matrix)."""
    nq = cand_ids.shape[0]
    dev = corpus.device
    out_i = torch.full((nq, m), PAD, dtype=torch.int32, device=dev)
    out_d = torch.full((nq, m), INF, device=dev)
    out_p = torch.ones((nq, m), dtype=torch.int32, device=dev)
    step = max(1, min(chunk, nq))
    for lo in range(0, nq, step):
        hi = min(lo + step, nq)
        si, sd, sp = _prune_batch(corpus, q_ids[lo:hi], cand_ids[lo:hi],
                                  cand_d[lo:hi], m=m, mode=mode,
                                  keep_pruned=keep_pruned)
        out_i[lo:hi], out_d[lo:hi], out_p[lo:hi] = si, sd, sp
    return out_i, out_d, out_p


# ---------------------------------------------------------------------------
# deterministic scatter/cap symmetrize (intra-batch conflict resolution)
# ---------------------------------------------------------------------------

def _merge_cap(adj: torch.Tensor, adj_d: torch.Tensor, adj_p: torch.Tensor,
               new_tgt: torch.Tensor, new_src: torch.Tensor,
               new_d: torch.Tensor, new_p: torch.Tensor, *, m: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge incoming directed edges into the adjacency, capped at m.

    adj / adj_d / adj_p are (N+1, m) — row N is a scratch row absorbing
    masked writes.  Existing rows and the incoming (tgt, src, dist,
    priority) edges form one edge list; (target, source) duplicates are
    dropped keeping the best copy, entries are ranked per target by
    (priority, distance, source id) via composed stable sorts, and ranks
    < m are scattered back.  Priority 0 marks heuristically-selected
    (Alg 4) edges, 1 marks keepPruned fill and reverse edges, so degree
    capping evicts nearest-fill edges before the diverse long-range links.
    Every result row is self-loop-free and duplicate-free.
    """
    np1 = adj.shape[0]
    scratch = np1 - 1
    dev = adj.device

    ex_tgt = torch.arange(np1, dtype=torch.int32, device=dev)[:, None] \
        .expand(adj.shape).reshape(-1)
    tgt = torch.cat([ex_tgt, new_tgt.to(torch.int32)])
    src = torch.cat([adj.reshape(-1), new_src.to(torch.int32)])
    dd = torch.cat([adj_d.reshape(-1).float(), new_d.float()])
    pri = torch.cat([adj_p.reshape(-1).to(torch.int32),
                     new_p.to(torch.int32)])
    bad = (src < 0) | (src >= scratch) | (tgt < 0) | (tgt >= scratch) \
        | (src == tgt) | ~torch.isfinite(dd)
    tgt = torch.where(bad, scratch, tgt)
    src_k = torch.where(bad, scratch, src)
    dd = torch.where(bad, INF, dd)
    pri = torch.where(bad, 1, pri)

    def argsort(x):
        return torch.argsort(x, stable=True)

    # dedup by (target, source): stable lexicographic sort on
    # (target, source, priority, distance), flag adjacent repeats, scatter
    # the flags back.  The surviving copy is the best (priority, distance)
    # one — a reverse duplicate must not demote a selected edge to fill.
    o = argsort(dd)
    o = o[argsort(pri[o])]
    o = o[argsort(src_k[o])]
    perm = o[argsort(tgt[o])]
    t_s, s_s = tgt[perm], src_k[perm]
    dup_s = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                       (t_s[1:] == t_s[:-1]) & (s_s[1:] == s_s[:-1])
                       & (t_s[1:] < scratch)])
    dup = torch.zeros_like(dup_s).scatter(0, perm, dup_s)
    tgt = torch.where(dup, scratch, tgt)
    dd = torch.where(dup, INF, dd)
    pri = torch.where(dup, 1, pri)

    # rank per target by (priority, distance, source id): composed sorts
    o = argsort(src_k)
    tgt, src, dd, pri = tgt[o], src[o], dd[o], pri[o]
    o = argsort(dd)
    tgt, src, dd, pri = tgt[o], src[o], dd[o], pri[o]
    o = argsort(pri)
    tgt, src, dd, pri = tgt[o], src[o], dd[o], pri[o]
    o = argsort(tgt)
    tgt, src, dd, pri = tgt[o], src[o], dd[o], pri[o]
    pos = torch.arange(tgt.shape[0], dtype=torch.int64, device=dev)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       tgt[1:] != tgt[:-1]])
    group_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = pos - group_start

    keep = (rank < m) & (tgt < scratch) & torch.isfinite(dd)
    row = torch.where(keep, tgt.long(), scratch)
    col = torch.where(keep, rank, 0)
    out = torch.full((np1, m), PAD, dtype=torch.int32, device=dev)
    out[row, col] = torch.where(keep, src, PAD)
    out_d = torch.full((np1, m), INF, device=dev)
    out_d[row, col] = torch.where(keep, dd, INF)
    out_p = torch.ones((np1, m), dtype=torch.int32, device=dev)
    out_p[row, col] = torch.where(keep, pri, 1)
    return out, out_d, out_p


def _edges_both_ways(sel_ids: torch.Tensor, sel_d: torch.Tensor,
                     sel_p: torch.Tensor, node_ids: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Pruned selections -> forward + reverse directed edge arrays.

    Forward edges carry the prune's slot priority (0 = heuristic pick);
    reverse edges are always priority 1 — they were not chosen by the
    target's own diversification, so they compete as fill."""
    m = sel_ids.shape[1]
    tgt_f = node_ids.to(torch.int32).repeat_interleave(m)
    src_f = sel_ids.reshape(-1)
    d_f = sel_d.reshape(-1)
    p_f = sel_p.reshape(-1).to(torch.int32)
    return (torch.cat([tgt_f, src_f]), torch.cat([src_f, tgt_f]),
            torch.cat([d_f, d_f]), torch.cat([p_f, torch.ones_like(p_f)]))


# ---------------------------------------------------------------------------
# shared phases: levels, upper hierarchy, candidate helpers, repair
# ---------------------------------------------------------------------------

def _sample_levels(n: int, cfg: HNSWConfig,
                   rng: np.random.RandomState) -> np.ndarray:
    lv = np.minimum((-np.log(np.maximum(rng.random_sample(n), 1e-12))
                     * cfg.mL).astype(np.int64), 127).astype(np.int8)
    if not (lv >= 1).any():
        lv[0] = 1                                  # guarantee a hierarchy
    return lv


def _rowwise_dists(vecs: torch.Tensor, row_ids: torch.Tensor,
                   nbr_ids: torch.Tensor, metric: str,
                   chunk: int = ROW_CHUNK) -> torch.Tensor:
    """d(vecs[row_ids[i]], vecs[nbr_ids[i, j]]) -> (len, r) raw scores."""
    out = torch.empty(nbr_ids.shape, dtype=torch.float32, device=vecs.device)
    r = nbr_ids.shape[1]
    for lo in range(0, row_ids.shape[0], chunk):
        hi = min(lo + chunk, row_ids.shape[0])
        a = vecs[row_ids[lo:hi].long()]
        b = vecs[nbr_ids[lo:hi].reshape(-1).long()].reshape(hi - lo, r, -1)
        out[lo:hi] = gathered_dists(a, b, metric)
    return out


def _build_upper(vecs: torch.Tensor, levels: np.ndarray, cfg: HNSWConfig,
                 rng: np.random.RandomState, mode: str
                 ) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
    """Per-layer kNN hierarchy among layer members (seed-builder semantics:
    symmetrized member kNN + a couple of random member links per node).
    The member kNN runs on the device, the link sets on the host."""
    max_level = int(levels.max())
    upper_ids = np.where(levels >= 1)[0].astype(np.int32)
    slot_of = {int(g): s for s, g in enumerate(upper_ids)}
    l_top = max(max_level, 1)
    upper_adj = np.full((len(upper_ids), l_top, cfg.M), PAD, dtype=np.int32)
    for layer in range(1, max_level + 1):
        members = upper_ids[levels[upper_ids] >= layer]
        if len(members) <= 1:
            continue
        kk = min(max(cfg.M - 2, 1), len(members) - 1)
        mv = vecs[torch.as_tensor(members, device=vecs.device).long()]
        nn = knn_ids_dists(mv, mv, kk + 1, metric=mode)[0][:, 1:]
        mem = members.tolist()
        links = {g: set(row) for g, row in
                 zip(mem, members[nn.cpu().numpy()].tolist())}
        for g in mem:
            for j in rng.randint(0, len(members), size=2):
                if mem[j] != g:
                    links[g].add(mem[j])
            links[g].discard(g)
            for nb in list(links[g]):
                links[nb].add(g)
        for g, nbrs in links.items():
            row = [slot_of[nb] for nb in sorted(nbrs)[: cfg.M]]
            upper_adj[slot_of[g], layer - 1, : len(row)] = row
    top_members = upper_ids[levels[upper_ids] >= max_level]
    entry_global = (int(top_members[0]) if len(top_members)
                    else int(upper_ids[0]))
    return (upper_ids, upper_adj, max_level, entry_global,
            slot_of.get(entry_global, 0))


def _bfs_reachable(adj0: np.ndarray, entry: int) -> np.ndarray:
    n = adj0.shape[0]
    seen = np.zeros(n, dtype=bool)
    frontier = np.array([entry], dtype=np.int64)
    seen[entry] = True
    while len(frontier):
        nxt = adj0[frontier].reshape(-1)
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt)
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


def _repair_connectivity(vecs: torch.Tensor, adj0: np.ndarray,
                         adj0_d: np.ndarray, entry: int, mode: str) -> int:
    """Attach components unreachable from the entry point: every stranded
    node gets a bidirectional link to its nearest reachable node (replacing
    the farthest slot when the row is full).  Mutates adj0/adj0_d in place;
    returns the number of repaired nodes."""
    seen = _bfs_reachable(adj0, entry)
    lost = np.where(~seen)[0]
    if len(lost) == 0:
        return 0
    anchors = np.where(seen)[0]
    ids, dd = knn_ids_dists(vecs[torch.as_tensor(lost, device=vecs.device)],
                            vecs[torch.as_tensor(anchors, device=vecs.device)],
                            1, metric=mode)
    near = anchors[ids[:, 0].cpu().numpy()]
    for u, a, d in zip(lost, near, dd[:, 0].cpu().numpy()):
        for node, other in ((int(a), int(u)), (int(u), int(a))):
            row = adj0[node]
            if other in row:
                continue
            slot = int(np.argmax(row == PAD)) if (row == PAD).any() \
                else row.shape[0] - 1
            row[slot] = other
            adj0_d[node, slot] = d
    return int(len(lost))


def _graph(vecs, adj, n, upper, entry_global, entry_upper) -> HNSWGraph:
    return HNSWGraph(vectors=vecs, adj0=adj[:n], upper_ids=upper[0],
                     upper_adj=upper[1], entry_global=entry_global,
                     entry_upper=entry_upper)


def _pad_batch(bids: torch.Tensor, batch: int, n: int) -> torch.Tensor:
    """Pad a tail batch of node ids with the out-of-range id n."""
    if len(bids) == batch:
        return bids
    return torch.cat([bids, torch.full((batch - len(bids),), n,
                                       dtype=bids.dtype, device=bids.device)])


# ---------------------------------------------------------------------------
# mode 1: level-wise batched inserts over the frozen prefix
# ---------------------------------------------------------------------------

def _bulk_level(vecs: torch.Tensor, cfg: HNSWConfig,
                rng: np.random.RandomState, levels: np.ndarray, graph_meta,
                mode: str, progress: Optional[ProgressFn]
                ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    upper_ids, upper_adj, max_level, entry_global, entry_upper = graph_meta
    n = vecs.shape[0]
    dev = vecs.device
    m0 = cfg.m0
    ef_build = cfg.ef_build or cfg.ef_construction
    k_base = min(m0 + cfg.M, n - 1)
    r = min(cfg.M, 8, n - 1)

    adj = torch.full((n + 1, m0), PAD, dtype=torch.int32, device=dev)
    adj_d = torch.full((n + 1, m0), INF, device=dev)
    adj_p = torch.ones((n + 1, m0), dtype=torch.int32, device=dev)

    # descending-level insertion order puts every upper-layer node (entry
    # point included) into the bootstrap set, so beam descents always land
    # on linked prefix nodes
    order = np.argsort(-levels.astype(np.int64), kind="stable")
    order_t = torch.as_tensor(order, device=dev)
    batch = min(cfg.build_batch, n)
    b0 = min(n, max(batch, len(upper_ids)))
    boot = order_t[:b0]

    def add_edges(sel_i, sel_d, sel_p, node_ids):
        nonlocal adj, adj_d, adj_p
        adj, adj_d, adj_p = _merge_cap(
            adj, adj_d, adj_p, *_edges_both_ways(sel_i, sel_d, sel_p,
                                                 node_ids), m=m0)

    # ---- bootstrap: exact kNN + prune among the first b0 nodes
    kb = min(k_base + 1, b0)
    loc_ids, cand_d = knn_ids_dists(vecs[boot], vecs[boot], kb, metric=mode)
    cand_i = boot[loc_ids].to(torch.int32)
    if r > 0:
        rnd = torch.as_tensor(order[rng.randint(0, b0, size=(b0, r))]
                              .astype(np.int32), device=dev)
        cand_i = torch.cat([cand_i, rnd], 1)
        cand_d = torch.cat([cand_d, _rowwise_dists(vecs, boot, rnd, mode)], 1)
    add_edges(*_prune_chunks(vecs, boot, cand_i, cand_d, m=m0, mode=mode,
                             keep_pruned=cfg.keep_pruned), boot)
    if progress is not None:
        progress("insert", b0, n)
    logger.debug("bulk level: bootstrap %d/%d", b0, n)

    # ---- batched level-wise growth over the frozen prefix
    upper = (torch.as_tensor(upper_ids, device=dev).long(),
             torch.as_tensor(upper_adj, device=dev).long())
    k_beam = min(k_base, ef_build)
    k_intra = min(8, batch - 1) if batch > 1 else 0
    width = max(cfg.expansion_width, 8)
    n_batches = 0
    for lo in range(b0, n, batch):
        hi = min(lo + batch, n)
        bids = _pad_batch(order_t[lo:hi], batch, n)
        q = vecs[bids.clamp_max(n - 1)]
        bd, bi = beam_search(_graph(vecs, adj, n, upper, entry_global,
                                    entry_upper),
                             q, k=k_beam, ef=ef_build, max_level=max_level,
                             metric=mode, expansion_width=width)
        cand_i, cand_d = [bi], [bd]
        if k_intra > 0:
            ii, idd = knn_ids_dists(q, q, k_intra + 1, metric=mode)
            cand_i.append(bids[ii].to(torch.int32))
            cand_d.append(idd)
        if r > 0:
            rnd = torch.as_tensor(order[rng.randint(0, hi, size=(batch, r))]
                                  .astype(np.int32), device=dev)
            cand_i.append(rnd)
            cand_d.append(_rowwise_dists(vecs, bids.clamp_max(n - 1), rnd,
                                         mode))
        ci = torch.cat([c.to(torch.int32) for c in cand_i], 1)
        cd = torch.cat(cand_d, 1)
        sel_i, sel_d, sel_p = _prune_chunks(vecs, bids, ci, cd, m=m0,
                                            mode=mode,
                                            keep_pruned=cfg.keep_pruned,
                                            chunk=batch)
        pad_rows = bids >= n
        sel_i[pad_rows] = PAD
        sel_d[pad_rows] = INF
        add_edges(sel_i, sel_d, sel_p, bids)
        n_batches += 1
        if progress is not None:
            progress("insert", hi, n)
        logger.debug("bulk level: %d/%d inserted", hi, n)

    return (adj[:n].cpu().numpy(), adj_d[:n].cpu().numpy(),
            {"build_batches": n_batches + 1, "build_bootstrap": int(b0)})


# ---------------------------------------------------------------------------
# mode 2: two-phase coarse build (cluster -> link -> stitch)
# ---------------------------------------------------------------------------

def _coarse_candidates(vecs: torch.Tensor, cfg: HNSWConfig,
                       rng: np.random.RandomState, mode: str,
                       progress: Optional[ProgressFn]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  int]:
    """k-means cluster the corpus, then exact-kNN each node against the
    union of its two nearest clusters.  Returns (cand_ids, cand_d,
    boundary_margin, nlist); margin is the assignment-score gap (small =
    near a cluster boundary = stitch candidate)."""
    n = vecs.shape[0]
    dev = vecs.device
    nlist = max(1, int(round(n / cfg.coarse_cluster)))
    # candidate pool per node: one full adjacency row of slots plus half the
    # construction beam (priority-aware capping keeps the diverse picks)
    ef_b = cfg.ef_build or cfg.ef_construction
    kc = min(max(cfg.m0 + cfg.M, ef_b // 2) + 2, n)

    if nlist <= 1:
        ids, dd = knn_ids_dists(vecs, vecs, kc, metric=mode)
        return (ids.to(torch.int32), dd,
                torch.zeros(n, dtype=torch.float32, device=dev), 1)

    samp = rng.choice(n, size=min(n, max(nlist * 64, 4096)), replace=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    cent = _fit_one_subspace(gen, vecs[torch.as_tensor(samp, device=dev)],
                             nlist, KMEANS_ITERS)
    if progress is not None:
        progress("cluster", nlist, nlist)

    # two nearest centroids per node: boundary nodes see both clusters
    a1 = torch.empty(n, dtype=torch.int64, device=dev)
    a2 = torch.empty(n, dtype=torch.int64, device=dev)
    margin = torch.empty(n, dtype=torch.float32, device=dev)
    cc = (cent * cent).sum(1)
    for lo in range(0, n, ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, n)
        blk = vecs[lo:hi]
        if mode == "l2":
            d = (blk * blk).sum(1)[:, None] + cc[None, :] - 2.0 * (blk @ cent.T)
        else:
            d = -(blk @ cent.T)
        dt, top2 = topk_smallest(d, 2)
        a1[lo:hi], a2[lo:hi] = top2[:, 0], top2[:, 1]
        margin[lo:hi] = dt[:, 1] - dt[:, 0]

    cand_i = torch.full((n, kc), PAD, dtype=torch.int32, device=dev)
    cand_d = torch.full((n, kc), INF, device=dev)
    for c in range(nlist):
        prim = torch.nonzero(a1 == c)[:, 0]
        if prim.numel() == 0:
            continue
        mem = torch.nonzero((a1 == c) | (a2 == c))[:, 0]
        kk = min(kc, mem.numel())
        loc, dd = knn_ids_dists(vecs[prim], vecs[mem], kk, metric=mode)
        cand_i[prim, :kk] = mem[loc].to(torch.int32)
        cand_d[prim, :kk] = dd
        if progress is not None:
            progress("link", c + 1, nlist)
        logger.debug("bulk coarse: cluster %d/%d linked (%d members)",
                     c + 1, nlist, mem.numel())
    return cand_i, cand_d, margin, nlist


def _bulk_coarse(vecs: torch.Tensor, cfg: HNSWConfig,
                 rng: np.random.RandomState, levels: np.ndarray, graph_meta,
                 mode: str, progress: Optional[ProgressFn]
                 ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    upper_ids, upper_adj, max_level, entry_global, entry_upper = graph_meta
    n = vecs.shape[0]
    dev = vecs.device
    m0 = cfg.m0
    r = min(cfg.M, 8, n - 1)

    cand_i, cand_d, margin, nlist = _coarse_candidates(
        vecs, cfg, rng, mode, progress)
    all_ids = torch.arange(n, dtype=torch.int32, device=dev)
    if r > 0:
        rnd = torch.as_tensor(rng.randint(0, n, size=(n, r)).astype(np.int32),
                              device=dev)
        cand_i = torch.cat([cand_i, rnd], 1)
        cand_d = torch.cat([cand_d, _rowwise_dists(vecs, all_ids, rnd, mode)],
                           1)

    sel_i, sel_d, sel_p = _prune_chunks(vecs, all_ids, cand_i, cand_d,
                                        m=m0, mode=mode,
                                        keep_pruned=cfg.keep_pruned)
    if progress is not None:
        progress("prune", n, n)

    adj = torch.full((n + 1, m0), PAD, dtype=torch.int32, device=dev)
    adj_d = torch.full((n + 1, m0), INF, device=dev)
    adj_p = torch.ones((n + 1, m0), dtype=torch.int32, device=dev)
    adj, adj_d, adj_p = _merge_cap(
        adj, adj_d, adj_p, *_edges_both_ways(sel_i, sel_d, sel_p, all_ids),
        m=m0)

    # ---- cross-cluster stitching: boundary nodes re-search the built graph
    n_stitch = int(round(cfg.stitch_frac * n)) if nlist > 1 else 0
    if n_stitch > 0:
        ef_st = max(min(cfg.ef_build or STITCH_EF, STITCH_EF), cfg.M)
        k_st = min(min(m0 + cfg.M, n - 1), ef_st)
        width = max(cfg.expansion_width, 8)
        boundary = torch.argsort(margin, stable=True)[:n_stitch]
        batch = min(cfg.build_batch, n_stitch)
        upper = (torch.as_tensor(upper_ids, device=dev).long(),
                 torch.as_tensor(upper_adj, device=dev).long())
        for lo in range(0, n_stitch, batch):
            hi = min(lo + batch, n_stitch)
            bids = _pad_batch(boundary[lo:hi], batch, n)
            safe = bids.clamp_max(n - 1)
            bd, bi = beam_search(_graph(vecs, adj, n, upper, entry_global,
                                        entry_upper),
                                 vecs[safe], k=k_st, ef=ef_st,
                                 max_level=max_level, metric=mode,
                                 expansion_width=width)
            # merge beam hits with the node's existing row, re-prune
            ci = torch.cat([bi, adj[safe]], 1)
            cd = torch.cat([bd, adj_d[safe]], 1)
            sel_i, sel_d, sel_p = _prune_chunks(vecs, bids, ci, cd, m=m0,
                                                mode=mode,
                                                keep_pruned=cfg.keep_pruned,
                                                chunk=batch)
            pad_rows = bids >= n
            sel_i[pad_rows] = PAD
            sel_d[pad_rows] = INF
            adj, adj_d, adj_p = _merge_cap(
                adj, adj_d, adj_p,
                *_edges_both_ways(sel_i, sel_d, sel_p, bids), m=m0)
            if progress is not None:
                progress("stitch", hi, n_stitch)
        logger.debug("bulk coarse: stitched %d boundary nodes", n_stitch)

    return (adj[:n].cpu().numpy(), adj_d[:n].cpu().numpy(),
            {"build_clusters": nlist, "build_stitched": n_stitch})


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def bulk_build_device(vectors: np.ndarray,
                      config: HNSWConfig = HNSWConfig(),
                      progress: Optional[ProgressFn] = None,
                      device="cuda") -> PackedHNSW:
    """Device-parallel bulk HNSW build (the `builder="bulk"` engine path).

    Dispatches on ``config.bulk_mode``: "level" = batched level-wise
    inserts via beam descents over the frozen prefix; "coarse" = two-phase
    k-means clustering + intra-cluster linking + boundary stitching;
    "auto" picks coarse at ``coarse_threshold`` rows.  Corpora below
    ``MIN_DEVICE_N`` rows use the numpy reference ``bulk_build``.  The
    device phases run on ``device`` (the card unless the caller asks for
    the CPU); the result is a host-side `PackedHNSW`.
    """
    dev = resolve_device(device)
    cfg = config
    vecs = preprocess_vectors(vectors, cfg.metric)
    n = vecs.shape[0]
    if n < MIN_DEVICE_N:
        packed = bulk_build(vectors, cfg, progress=progress)
        packed.build_info = {"builder_mode": "ref_small_n"}
        return packed

    mode = cfg.bulk_mode
    if mode == "auto":
        mode = "coarse" if n >= cfg.coarse_threshold else "level"
    dev_metric = "l2" if cfg.metric == "l2" else "dot"

    rng = np.random.RandomState(cfg.seed)
    levels = _sample_levels(n, cfg, rng)
    vecs_dev = torch.as_tensor(vecs).to(dev)
    graph_meta = _build_upper(vecs_dev, levels, cfg, rng, dev_metric)
    upper_ids, upper_adj, max_level, entry_global, entry_upper = graph_meta

    build_fn = _bulk_coarse if mode == "coarse" else _bulk_level
    adj0, adj0_d, info = build_fn(vecs_dev, cfg, rng, levels, graph_meta,
                                  dev_metric, progress)

    repaired = _repair_connectivity(vecs_dev, adj0, adj0_d, entry_global,
                                    dev_metric)
    if repaired:
        logger.info("bulk build: reattached %d stranded nodes", repaired)
    info.update({"builder_mode": mode, "build_repaired": repaired})

    return PackedHNSW(config=cfg, vectors=vecs, adj0=adj0,
                      upper_ids=upper_ids, upper_adj=upper_adj,
                      levels=levels, entry_global=entry_global,
                      entry_upper=entry_upper, max_level=max_level,
                      build_info=info)
