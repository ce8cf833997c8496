"""HNSW graph construction (paper §II-B-1), faithful to Malkov & Yashunin.

Copy of the JAX package's ``repro.core.hnsw_build`` (numpy only), with one
change: `knn_ids_dists` also takes torch tensors and then runs the same exact
kNN on their device (one ``torch.matmul`` per block plus the port's
tie-stable top-k), which is what the device bulk builder calls.

Construction is inherently sequential (each insert searches the graph built so
far), so — exactly as real deployments do (indexes are built offline on host
CPUs, then served from accelerators) — the builder runs host-side in numpy,
and the *search* runs on-device (see hnsw_search.py).  The builder vectorises
each beam expansion (one gather + one GEMM per expansion) instead of scalar
distance calls.

Algorithms implemented (numbering from the paper's reference [1]):
  * Alg 1 INSERT         — level sampling l = ⌊−ln(U)·mL⌋, mL = 1/ln(M);
                           greedy descent above l, ef_construction beam at ≤ l.
  * Alg 2 SEARCH-LAYER   — beam search with visited set, ef-bounded result heap.
  * Alg 4 SELECT-NEIGHBORS-HEURISTIC — keep candidate e iff it is closer to q
                           than to every already-selected neighbour (with
                           keepPruned fill-up), which preserves long-range
                           "small-world" links.
  * M_max enforcement    — overflowing nodes are re-pruned with the heuristic.

A second, beyond-paper builder (`bulk_build`) constructs the same packed
structure from an exact kNN graph computed as one big GEMM (device-friendly,
CAGRA-style bulk build) — orders of magnitude faster for large corpora; its
recall is compared against the faithful builder in tests/benchmarks.

Output is a `PackedHNSW`: fixed-shape, padded dense arrays that the jitted
TPU search consumes (see DESIGN.md §2 for the adaptation rationale).
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .flat import merge_topk, topk_smallest

PAD = -1  # padding sentinel in adjacency rows

logger = logging.getLogger(__name__)

# optional build-progress callback: (phase, done, total) -> None
ProgressFn = Callable[[str, int, int], None]


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    M: int = 16                    # max out-degree at layers >= 1
    M0: Optional[int] = None       # max out-degree at layer 0 (default 2M)
    ef_construction: int = 100
    metric: str = "cosine"         # "cosine" | "l2" | "dot"
    seed: int = 0
    extend_candidates: bool = False
    keep_pruned: bool = True
    # search-time default: candidates popped per wide-beam iteration
    # (1 == classic single-pop traversal); per-query override rides the
    # engine/API search path
    expansion_width: int = 4
    # --- device bulk-builder knobs (core/hnsw_bulk.py) ---
    bulk_mode: str = "auto"        # "auto" | "level" | "coarse"
    build_batch: int = 1024        # nodes per level-wise insert step
    ef_build: Optional[int] = None  # construction beam (None -> ef_construction)
    coarse_threshold: int = 1024   # auto: two-phase coarse path at n >= this
    coarse_cluster: int = 8192     # target rows per coarse k-means cluster
    #   (single global-kNN cluster up to ~12k rows — chunked GEMM keeps the
    #   quadratic self-join cheap there, and skipping k-means + boundary
    #   stitching is both faster and higher-recall at that scale)
    stitch_frac: float = 0.1       # fraction of boundary nodes beam-stitched

    def __post_init__(self):
        if self.expansion_width < 1:
            raise ValueError(
                f"expansion_width must be >= 1, got {self.expansion_width}")
        if self.bulk_mode not in ("auto", "level", "coarse"):
            raise ValueError(f"bulk_mode must be auto|level|coarse, "
                             f"got {self.bulk_mode!r}")
        if self.build_batch < 1:
            raise ValueError(
                f"build_batch must be >= 1, got {self.build_batch}")
        if self.coarse_cluster < 1:
            raise ValueError(
                f"coarse_cluster must be >= 1, got {self.coarse_cluster}")
        if not 0.0 <= self.stitch_frac <= 1.0:
            raise ValueError(
                f"stitch_frac must be in [0, 1], got {self.stitch_frac}")

    @property
    def m0(self) -> int:
        return self.M0 if self.M0 is not None else 2 * self.M

    @property
    def mL(self) -> float:
        return 1.0 / math.log(self.M)


@dataclasses.dataclass
class PackedHNSW:
    """Fixed-shape dense-graph representation consumed by the jitted search.

    vectors are stored metric-preprocessed (unit-normalized for cosine) so the
    device search can use the cheap dot/L2 form directly.
    """

    config: HNSWConfig
    vectors: np.ndarray        # (N, D) float32, preprocessed
    adj0: np.ndarray           # (N, M0) int32 global ids, PAD-filled
    upper_ids: np.ndarray      # (n_upper,) int32: upper-slot -> global id
    upper_adj: np.ndarray      # (n_upper, L_top, M) int32 *upper-slot* ids
    levels: np.ndarray         # (N,) int8 node levels
    entry_global: int
    entry_upper: int
    max_level: int
    # builder observability (mode, batch/cluster/stitch counters); not
    # serialized — checkpoints restore it empty
    build_info: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    def degree_stats(self) -> Dict[str, float]:
        deg0 = (self.adj0 != PAD).sum(1)
        return {"mean_deg0": float(deg0.mean()), "max_deg0": float(deg0.max()),
                "n_upper": float(len(self.upper_ids)),
                "max_level": float(self.max_level)}

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {
            "vectors": self.vectors, "adj0": self.adj0,
            "upper_ids": self.upper_ids, "upper_adj": self.upper_adj,
            "levels": self.levels,
            "meta": np.array([self.entry_global, self.entry_upper,
                              self.max_level], dtype=np.int64),
        }

    @classmethod
    def from_state_dict(cls, state, config: HNSWConfig) -> "PackedHNSW":
        eg, eu, ml = (int(v) for v in state["meta"])
        return cls(config=config, vectors=state["vectors"], adj0=state["adj0"],
                   upper_ids=state["upper_ids"], upper_adj=state["upper_adj"],
                   levels=state["levels"], entry_global=eg, entry_upper=eu,
                   max_level=ml)


# ---------------------------------------------------------------------------
# metric preprocessing: map every metric onto "smaller raw score == closer"
# ---------------------------------------------------------------------------

def preprocess_vectors(x: np.ndarray, metric: str) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if metric == "cosine":
        n = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(n, 1e-12)
    return x


def make_dist_fn(vectors: np.ndarray, metric: str) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """(q (D,), ids (m,)) -> (m,) distances. cosine inputs are pre-normalized
    so cosine == 1 - dot == monotone in dot; we use -dot for speed."""
    if metric in ("cosine", "dot"):
        def fn(q, ids):
            return -(vectors[ids] @ q)
    elif metric == "l2":
        def fn(q, ids):
            d = vectors[ids] - q[None, :]
            return np.einsum("md,md->m", d, d)
    else:  # pragma: no cover
        raise ValueError(f"unsupported metric {metric}")
    return fn


# ---------------------------------------------------------------------------
# Faithful incremental builder
# ---------------------------------------------------------------------------

class _GraphBuilder:
    """Adjacency as python lists during construction; packed at the end."""

    def __init__(self, cfg: HNSWConfig, vectors: np.ndarray):
        self.cfg = cfg
        self.vectors = vectors
        self.n = vectors.shape[0]
        self.levels = np.zeros((self.n,), dtype=np.int8)
        # adj[layer][node] -> list[int]; layer 0 exists for every node.
        self.adj: List[Dict[int, List[int]]] = [dict()]
        self.entry: int = -1
        self.max_level: int = -1
        self.dist = make_dist_fn(vectors, cfg.metric)
        self._rng = np.random.RandomState(cfg.seed)

    # -- Alg 2: search one layer ------------------------------------------------
    def search_layer(self, q: np.ndarray, eps: List[int], ef: int,
                     layer: int) -> List[Tuple[float, int]]:
        adj = self.adj[layer]
        dist = self.dist
        visited = set(eps)
        ep_d = dist(q, np.fromiter(eps, np.int64, len(eps)))
        cand: List[Tuple[float, int]] = [(float(d), e) for d, e in zip(ep_d, eps)]
        heapq.heapify(cand)                       # min-heap on distance
        res: List[Tuple[float, int]] = [(-d, e) for d, e in cand]
        heapq.heapify(res)                        # max-heap via negation
        while len(res) > ef:
            heapq.heappop(res)
        while cand:
            d_c, c = heapq.heappop(cand)
            if d_c > -res[0][0] and len(res) >= ef:
                break
            fresh = [e for e in adj.get(c, ()) if e not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            ids = np.fromiter(fresh, np.int64, len(fresh))
            ds = dist(q, ids)                     # vectorized expansion
            bound = -res[0][0]
            for d_e, e in zip(ds, fresh):
                d_e = float(d_e)
                if len(res) < ef or d_e < bound:
                    heapq.heappush(cand, (d_e, e))
                    heapq.heappush(res, (-d_e, e))
                    if len(res) > ef:
                        heapq.heappop(res)
                    bound = -res[0][0]
        return sorted((-d, e) for d, e in res)    # ascending distance

    # -- Alg 4: heuristic neighbour selection ----------------------------------
    def select_neighbors(self, q_vec: np.ndarray,
                         cand: List[Tuple[float, int]], m: int,
                         layer: int) -> List[int]:
        cfg = self.cfg
        work = list(cand)
        if cfg.extend_candidates:
            seen = {e for _, e in work}
            extra = []
            for _, e in cand:
                for nb in self.adj[layer].get(e, ()):  # pragma: no cover (off by default)
                    if nb not in seen:
                        seen.add(nb)
                        extra.append(nb)
            if extra:
                ids = np.fromiter(extra, np.int64, len(extra))
                ds = self.dist(q_vec, ids)
                work.extend((float(d), e) for d, e in zip(ds, extra))
        work.sort()
        selected: List[int] = []
        pruned: List[Tuple[float, int]] = []
        for d_e, e in work:
            if len(selected) >= m:
                break
            if not selected:
                selected.append(e)
                continue
            sel_ids = np.fromiter(selected, np.int64, len(selected))
            d_to_sel = self.dist(self.vectors[e], sel_ids)
            if d_e < float(d_to_sel.min()):       # closer to q than to selection
                selected.append(e)
            else:
                pruned.append((d_e, e))
        if self.cfg.keep_pruned:
            for d_e, e in pruned:
                if len(selected) >= m:
                    break
                selected.append(e)
        return selected

    def _link(self, a: int, b: int, layer: int) -> None:
        self.adj[layer].setdefault(a, []).append(b)

    def _shrink(self, e: int, layer: int) -> None:
        m_max = self.cfg.m0 if layer == 0 else self.cfg.M
        nbrs = self.adj[layer].get(e, [])
        if len(nbrs) <= m_max:
            return
        ids = np.fromiter(nbrs, np.int64, len(nbrs))
        ds = self.dist(self.vectors[e], ids)
        cand = sorted((float(d), nb) for d, nb in zip(ds, nbrs))
        self.adj[layer][e] = self.select_neighbors(self.vectors[e], cand,
                                                   m_max, layer)

    # -- Alg 1: insert ----------------------------------------------------------
    def insert(self, idx: int) -> None:
        cfg = self.cfg
        q = self.vectors[idx]
        l_new = int(-math.log(max(self._rng.random_sample(), 1e-12)) * cfg.mL)
        self.levels[idx] = min(l_new, 127)
        while len(self.adj) <= l_new:
            self.adj.append(dict())
        for layer in range(l_new + 1):
            self.adj[layer].setdefault(idx, [])

        if self.entry < 0:                         # first element
            self.entry, self.max_level = idx, l_new
            return

        ep = [self.entry]
        # greedy descent with ef=1 above the insertion level
        for layer in range(self.max_level, l_new, -1):
            ep = [self.search_layer(q, ep, 1, layer)[0][1]]
        # beam insert at each layer <= min(l_new, max_level)
        for layer in range(min(self.max_level, l_new), -1, -1):
            cand = self.search_layer(q, ep, cfg.ef_construction, layer)
            m = cfg.m0 if layer == 0 else cfg.M
            nbrs = self.select_neighbors(q, cand, m, layer)
            for e in nbrs:
                self._link(idx, e, layer)
                self._link(e, idx, layer)
                self._shrink(e, layer)
            ep = [e for _, e in cand]
        if l_new > self.max_level:
            self.entry, self.max_level = idx, l_new


def _pack(builder: _GraphBuilder) -> PackedHNSW:
    cfg, n = builder.cfg, builder.n
    adj0 = np.full((n, cfg.m0), PAD, dtype=np.int32)
    for node, nbrs in builder.adj[0].items():
        row = nbrs[: cfg.m0]
        adj0[node, : len(row)] = row

    upper_ids = np.where(builder.levels >= 1)[0].astype(np.int32)
    slot_of = {int(g): s for s, g in enumerate(upper_ids)}
    l_top = max(builder.max_level, 1)
    upper_adj = np.full((max(len(upper_ids), 1), l_top, cfg.M), PAD,
                        dtype=np.int32)
    for layer in range(1, builder.max_level + 1):
        for node, nbrs in builder.adj[layer].items():
            s = slot_of[node]
            row = [slot_of[e] for e in nbrs[: cfg.M]]
            upper_adj[s, layer - 1, : len(row)] = row

    entry_upper = slot_of.get(builder.entry, 0) if len(upper_ids) else 0
    return PackedHNSW(
        config=cfg, vectors=builder.vectors, adj0=adj0,
        upper_ids=upper_ids if len(upper_ids) else np.zeros((1,), np.int32),
        upper_adj=upper_adj, levels=builder.levels,
        entry_global=builder.entry, entry_upper=entry_upper,
        max_level=builder.max_level)


def build(vectors: np.ndarray, config: HNSWConfig = HNSWConfig(),
          insert_order: Optional[np.ndarray] = None,
          progress: Optional[ProgressFn] = None) -> PackedHNSW:
    """Faithful incremental HNSW build."""
    vecs = preprocess_vectors(vectors, config.metric)
    b = _GraphBuilder(config, vecs)
    order = (np.arange(b.n) if insert_order is None
             else np.asarray(insert_order, dtype=np.int64))
    report_every = max(1, b.n // 20)
    for i, idx in enumerate(order):
        b.insert(int(idx))
        done = i + 1
        if done % report_every == 0 or done == b.n:
            logger.debug("incremental build: %d/%d inserted", done, b.n)
            if progress is not None:
                progress("insert", done, b.n)
    return _pack(b)


# ---------------------------------------------------------------------------
# Bulk builder (beyond-paper): exact-kNN graph -> pruned navigable graph
# ---------------------------------------------------------------------------

def bulk_build(vectors: np.ndarray, config: HNSWConfig = HNSWConfig(),
               knn_indices: Optional[np.ndarray] = None,
               chunk: int = 4096,
               progress: Optional[ProgressFn] = None) -> PackedHNSW:
    """Build the packed structure from an exact kNN graph (one GEMM per chunk).

    Level structure is sampled with the same geometric distribution; layer-l
    adjacency connects each upper node to its nearest peers *within the same
    layer's node set* — preserving the hierarchy's coarse-to-fine routing.
    The base layer applies the Alg-4 diversification heuristic to the kNN
    candidate list (this is what turns a kNN graph into a navigable graph).
    """
    cfg = config
    vecs = preprocess_vectors(vectors, cfg.metric)
    n, d = vecs.shape
    rng = np.random.RandomState(cfg.seed)
    k = min(cfg.m0 + cfg.M, n - 1)

    if knn_indices is None:
        knn_indices = exact_knn(vecs, vecs, k + 1, metric=cfg.metric,
                                chunk=chunk)[:, 1:]  # drop self

    # long-range candidates: a pure kNN graph fragments on strongly
    # clustered data (no inter-cluster edges); random extras let the Alg-4
    # diversification heuristic keep a few far links per node — the
    # "small-world" property the incremental builder gets from its
    # insertion-time beam search.
    n_rand = min(cfg.M, max(n - 1, 1))
    rand_cands = rng.randint(0, n, size=(n, n_rand)).astype(np.int32)

    dist = make_dist_fn(vecs, cfg.metric)

    # base layer: heuristic-prune each node's kNN candidates to m0
    report_every = max(1, n // 10)
    adj0 = np.full((n, cfg.m0), PAD, dtype=np.int32)
    for i in range(n):
        if (i + 1) % report_every == 0 or i + 1 == n:
            logger.debug("bulk_ref prune: %d/%d", i + 1, n)
            if progress is not None:
                progress("prune", i + 1, n)
        cand_ids = np.unique(np.concatenate(
            [knn_indices[i], rand_cands[i]]))
        cand_ids = cand_ids[cand_ids != i]
        ds = dist(vecs[i], cand_ids.astype(np.int64))
        order = np.argsort(ds)
        selected: List[int] = []
        pruned: List[int] = []
        for o in order:
            e = int(cand_ids[o])
            if len(selected) >= cfg.m0:
                break
            if not selected:
                selected.append(e)
                continue
            sel = np.asarray(selected, dtype=np.int64)
            if float(ds[o]) < float(dist(vecs[e], sel).min()):
                selected.append(e)
            else:
                pruned.append(e)
        for e in pruned:
            if len(selected) >= cfg.m0:
                break
            selected.append(e)
        adj0[i, : len(selected)] = selected

    # symmetrize (bidirectional links), then cap at m0
    sym: List[List[int]] = [list(adj0[i][adj0[i] != PAD]) for i in range(n)]
    for i in range(n):
        for e in adj0[i]:
            if e != PAD and i not in sym[e]:
                sym[int(e)].append(i)
    adj0 = np.full((n, cfg.m0), PAD, dtype=np.int32)
    for i in range(n):
        row = sym[i]
        if len(row) > cfg.m0:
            ids = np.asarray(row, dtype=np.int64)
            ds = dist(vecs[i], ids)
            row = [row[j] for j in np.argsort(ds)[: cfg.m0]]
        adj0[i, : len(row)] = row

    # hierarchy: geometric level sampling, per-layer kNN among layer members
    levels = np.minimum((-np.log(np.maximum(rng.random_sample(n), 1e-12))
                         * cfg.mL).astype(np.int64), 127).astype(np.int8)
    max_level = int(levels.max()) if n else 0
    upper_ids = np.where(levels >= 1)[0].astype(np.int32)
    if len(upper_ids) == 0:
        upper_ids = np.array([0], dtype=np.int32)
        levels[0] = 1
        max_level = max(max_level, 1)
    slot_of = {int(g): s for s, g in enumerate(upper_ids)}
    l_top = max(max_level, 1)
    upper_adj = np.full((len(upper_ids), l_top, cfg.M), PAD, dtype=np.int32)
    for layer in range(1, max_level + 1):
        members = upper_ids[levels[upper_ids] >= layer]
        if len(members) <= 1:
            continue
        kk = min(max(cfg.M - 2, 1), len(members) - 1)
        nn = exact_knn(vecs[members], vecs[members], kk + 1,
                       metric=cfg.metric, chunk=chunk)[:, 1:]
        # symmetrized kNN + a couple of random member links per node —
        # upper-layer routing must not fragment on clustered data
        links = {int(g): set(int(members[j]) for j in nn[row_i])
                 for row_i, g in enumerate(members)}
        for row_i, g in enumerate(members):
            for j in rng.randint(0, len(members), size=2):
                if int(members[j]) != int(g):
                    links[int(g)].add(int(members[j]))
            for nb in list(links[int(g)]):
                links[nb].add(int(g))
        for g, nbrs in links.items():
            s = slot_of[g]
            row = [slot_of[nb] for nb in list(nbrs)[: cfg.M]]
            upper_adj[s, layer - 1, : len(row)] = row

    top_members = upper_ids[levels[upper_ids] >= max_level]
    entry_global = int(top_members[0]) if len(top_members) else int(upper_ids[0])
    return PackedHNSW(config=cfg, vectors=vecs, adj0=adj0, upper_ids=upper_ids,
                      upper_adj=upper_adj, levels=levels,
                      entry_global=entry_global,
                      entry_upper=slot_of.get(entry_global, 0),
                      max_level=max_level)


def exact_knn(queries: np.ndarray, corpus: np.ndarray, k: int,
              metric: str = "cosine", chunk: int = 4096) -> np.ndarray:
    """Host-side exact kNN ids (chunked GEMM); ground truth for recall tests."""
    q = preprocess_vectors(queries, metric)
    x = preprocess_vectors(corpus, metric)
    return knn_ids_dists(q, x, k, metric=metric, chunk=chunk)[0]


def knn_ids_dists(q, x, k: int, metric: str,
                  chunk: int = 4096,
                  corpus_chunk: Optional[int] = None):
    """Exact kNN over *preprocessed* vectors, chunked on BOTH axes.

    Never materializes more than a (chunk, corpus_chunk) distance block, so
    the self-join survives 100k+ row corpora where the old single-axis
    chunking allocated a full (chunk, N) row panel.  Returns (ids, dists)
    sorted ascending by raw score (squared L2 / negated dot).

    numpy inputs run on the host and return numpy (ids int32); torch inputs
    run on their device and return torch tensors there (ids int64), ties
    broken by the lowest corpus index.
    """
    if isinstance(q, torch.Tensor):
        return _knn_ids_dists_torch(q, x, k, metric, chunk, corpus_chunk)
    n = x.shape[0]
    k = min(k, n)
    if corpus_chunk is None:
        # bound the block to ~16M floats (64 MB) regardless of chunk size
        corpus_chunk = max(1024, (1 << 24) // max(chunk, 1))
    nq = q.shape[0]
    out_i = np.zeros((nq, k), dtype=np.int32)
    out_d = np.zeros((nq, k), dtype=np.float32)
    xx_all = (x * x).sum(1) if metric == "l2" else None
    for lo in range(0, nq, chunk):
        qc = q[lo: lo + chunk]
        qq = (qc * qc).sum(1)[:, None] if metric == "l2" else None
        best_d = np.full((qc.shape[0], k), np.inf, dtype=np.float32)
        best_i = np.full((qc.shape[0], k), PAD, dtype=np.int32)
        for clo in range(0, n, corpus_chunk):
            xc = x[clo: clo + corpus_chunk]
            if metric == "l2":
                d = qq + xx_all[clo: clo + corpus_chunk][None, :] \
                    - 2.0 * qc @ xc.T
            else:
                d = -(qc @ xc.T)
            kk = min(k, d.shape[1])
            idx = np.argpartition(d, kk - 1, axis=1)[:, :kk] \
                if kk < d.shape[1] else np.broadcast_to(
                    np.arange(d.shape[1], dtype=np.int64), d.shape)
            dd = np.take_along_axis(d, idx, axis=1)
            cat_d = np.concatenate([best_d, dd.astype(np.float32)], axis=1)
            cat_i = np.concatenate(
                [best_i, (idx + clo).astype(np.int32)], axis=1)
            sel = np.argpartition(cat_d, k - 1, axis=1)[:, :k] \
                if k < cat_d.shape[1] else np.broadcast_to(
                    np.arange(cat_d.shape[1], dtype=np.int64), cat_d.shape)
            best_d = np.take_along_axis(cat_d, sel, axis=1)
            best_i = np.take_along_axis(cat_i, sel, axis=1)
        order = np.argsort(best_d, axis=1, kind="stable")
        out_d[lo: lo + chunk] = np.take_along_axis(best_d, order, axis=1)
        out_i[lo: lo + chunk] = np.take_along_axis(best_i, order, axis=1)
    return out_i, out_d


def _knn_ids_dists_torch(q: torch.Tensor, x: torch.Tensor, k: int,
                         metric: str, chunk: int,
                         corpus_chunk: Optional[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`knn_ids_dists` on a torch device: the same distance block and the
    same streaming merge, with `topk_smallest` in place of argpartition."""
    n = x.shape[0]
    k = min(k, n)
    if corpus_chunk is None:
        corpus_chunk = max(1024, (1 << 24) // max(chunk, 1))
    q = q.float()
    x = x.float()
    xx_all = (x * x).sum(1) if metric == "l2" else None
    out_i, out_d = [], []
    for lo in range(0, q.shape[0], chunk):
        qc = q[lo: lo + chunk]
        qq = (qc * qc).sum(1)[:, None] if metric == "l2" else None
        best_d = best_i = None
        for clo in range(0, n, corpus_chunk):
            xc = x[clo: clo + corpus_chunk]
            if metric == "l2":
                d = qq + xx_all[clo: clo + corpus_chunk][None, :] \
                    - 2.0 * (qc @ xc.T)
            else:
                d = -(qc @ xc.T)
            dd, idx = topk_smallest(d, min(k, d.shape[1]))
            if best_d is None:
                best_d, best_i = dd, idx + clo
            else:
                best_d, best_i = merge_topk(best_d, best_i, dd, idx + clo, k)
        out_i.append(best_i)
        out_d.append(best_d)
    if not out_i:
        return (torch.zeros((0, k), dtype=torch.int64, device=q.device),
                torch.zeros((0, k), dtype=torch.float32, device=q.device))
    return torch.cat(out_i), torch.cat(out_d)
