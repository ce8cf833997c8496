"""`ShardedCollection`: one logical collection over N in-process shards.

Rows are hash-slot partitioned by string id (`repro_torch.cluster.router`); each
shard is a full single-engine `Collection` replicated `replicas` times.
The class speaks the exact `Collection` surface — `upsert`/`delete`/`get`/
`query()`/`execute_plan`/`stats`/`state_dict` — so the serving plane,
`Database` persistence, and the wire protocol treat both interchangeably.

Exactness is the design center: a sharded collection must return the SAME
hits as one engine over the same rows.

  * Global ids.  Every appended row gets a monotonically increasing global
    sequence number (seq) assigned in upsert-batch order — the same order a
    single engine numbers its rows — so every cross-shard tie-break
    (distance ties, BM25 score ties, RRF rank ties) resolves exactly as the
    single-engine row tie-break does.  Per shard, `gmap` (local row -> seq,
    append-only between compactions) and `rdict` (seq -> local row) carry
    the translation.
  * Exact top-k merge.  Plans scatter only at the leaf `ann`/`sparse`
    stages: each shard returns its local top-k, the union is re-sorted by
    (distance, seq) — top-k of a union of per-shard top-k is exactly the
    global top-k.  Fusion (RRF/linear) and rescore run GLOBALLY over seq
    ids, never per shard.
  * Exact distributed BM25.  Per-shard document frequencies would skew
    IDF, so sparse stages run two-phase: gather integer term statistics
    from every shard, `CorpusStats.aggregate` them, then score each shard
    with the GLOBAL stats — bit-identical to one index (integer sums
    commute; the float math then runs on identical inputs).

Concurrency mirrors `Collection`: non-trivial plans and all writes/topology
changes serialize under one collection-level lock; trivial single-vector
queries coalesce lock-free through ONE collection-level `RequestBatcher`
whose every flushed batch scatters to all shards as a single aligned wave
(the QPS-scaling path — per-shard batchers would fragment concurrent
callers into staggered partial flushes), then validate per-shard epochs and
the topology generation after the fact, retrying when a compaction or
rebalance raced them.

Rebalancing (`rebalance`/`split`/`move_slot`) is snapshot-based: every
source shard is committed through a `CheckpointStore` (the same artifact a
cross-node shard move would ship), restored, and re-upserted in global seq
order under the new routing table — queries in flight keep answering
against the old shard set and retry onto the new one after the swap.

Carried across from the JAX package's ``repro.cluster.sharded``; the one
change is the torch ``device``: every shard and replica engine lives on the
collection's one device (``ShardedCollection(schema, device=...)``), the
card unless the caller asks for the CPU, and a rebalance rebuilds its
shards there.  The fan-out threads launch their kernels on that device's
current stream.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import count
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..api.collection import (Collection, CollectionClosed, Entity,
                              QueryRetriesExhausted, _as_id_list)
from ..api.plan import (AnnStage, PlanExplain, QueryPlan, plan_to_dict,
                        recommend_vector, validate_filter, validate_plan)
from ..api.query import Hit, Query
from ..api.schema import BatcherConfig, CollectionSchema, SchemaError
from ..checkpoint.store import CheckpointStore
from ..core.executor import AnnParams, ExecResult, PlanExecutor
from ..core.metadata import Filter
from ..core.sparse import CorpusStats
from ..device import resolve_device
from ..serving.batcher import BatcherClosed, RequestBatcher
from .router import HASH_SLOTS, Router


class ShardUnavailable(RuntimeError):
    """Every replica of some shard refused the request (unhealthy or
    failed) — the query cannot be answered exactly, so it is not answered
    at all.  The service plane maps this to UNAVAILABLE (retryable)."""


class _ViewChanged(RuntimeError):
    """Internal: a compact()/rebalance() raced a batcher-path query; the
    rows it returned belong to a dead numbering.  Caught and retried."""


class _ShardView:
    """Immutable-by-convention snapshot of one shard's serving state.

    `replicas`/`epochs` never mutate after publication; `gmap`/`rdict` are
    the LIVE translation maps — append-only/insert-only between
    compactions (safe to read concurrently under the GIL), replaced
    wholesale (with a new view) whenever a compaction renumbers rows.
    `health` is a shared mutable list (reads tolerate stale values).
    """

    __slots__ = ("replicas", "health", "gmap", "rdict", "epochs", "rr")

    def __init__(self, replicas: Tuple[Collection, ...], health: List[bool],
                 gmap: List[int], rdict: Dict[int, int],
                 epochs: Tuple[int, ...], rr=None):
        self.replicas = replicas
        self.health = health
        self.gmap = gmap
        self.rdict = rdict
        self.epochs = epochs
        self.rr = rr if rr is not None else count()


class ShardedCollection:
    """Hash-partitioned, replicated collection behind the `Collection` API."""

    def __init__(self, schema: CollectionSchema, device="cuda"):
        if schema.shards < 1 or schema.replicas < 1:
            raise SchemaError("shards and replicas must be >= 1")
        self.schema = schema
        self.device = resolve_device(device)
        self._router = Router.even(schema.shards)   # guarded-by: _lock
        self._views: List[_ShardView] = [           # guarded-by: _lock
            self._make_shard(s, schema.replicas)
            for s in range(schema.shards)]
        self._seq_of: Dict[str, int] = {}      # guarded-by: _lock (live id->seq)
        self._id_of_seq: Dict[int, str] = {}   # guarded-by: _lock (live seq->id)
        self._next_seq = 0                     # guarded-by: _lock
        self._closed = False                   # guarded-by: _lock
        self._scatter_log: List[Dict[str, Any]] = []   # guarded-by: _lock
        # leaf-stage fan-out pool; per-shard work items never scatter again,
        # so the pool cannot deadlock on itself
        self._pool = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="qx-shard")
        self._lock = threading.RLock()
        # collection-level serving batcher (lazily started); bumps whenever
        # seq numbering may change (compact/rebalance) so lock-free readers
        # can tell a renumbering raced their round trip
        self._batcher: Optional[RequestBatcher] = None  # guarded-by: _batcher_init_lock
        self._batcher_init_lock = threading.Lock()
        self._topology_gen = 0                 # guarded-by: _lock

    # -------------------------------------------------------------- topology
    def _shard_schema(self, shard: int, replica: int) -> CollectionSchema:
        return dataclasses.replace(
            self.schema, name=f"{self.schema.name}.s{shard}r{replica}",
            shards=1, replicas=1)

    def _make_shard(self, shard: int, replicas: int) -> _ShardView:
        cols = tuple(Collection(self._shard_schema(shard, r),
                                device=self.device)
                     for r in range(replicas))
        return _ShardView(cols, [True] * replicas, [], {},
                          tuple(c.epoch for c in cols))

    # ------------------------------------------------------------ properties
    @property
    def name(self) -> str:
        return self.schema.name

    @property
    def num_shards(self) -> int:
        return len(self._views)  # unguarded-ok: atomic read of a published list

    def __len__(self) -> int:
        with self._lock:
            return len(self._seq_of)

    @property
    def tombstones(self) -> int:
        with self._lock:
            return sum(v.replicas[0].tombstones for v in self._views)

    def __contains__(self, id: str) -> bool:
        with self._lock:
            return id in self._seq_of

    def ids(self) -> List[str]:
        """Live ids in global insertion (seq) order — the same order a
        single engine would report."""
        with self._lock:
            return [self._id_of_seq[seq] for seq in sorted(self._id_of_seq)]

    # ---------------------------------------------------------------- writes
    def upsert(self, ids: Union[str, Sequence[str]],
               vectors: np.ndarray,
               payloads: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
               ) -> int:
        """Partition the batch by hash slot and fan each piece out to every
        replica of its shard.  Seqs are assigned by position in the ORIGINAL
        batch (before partitioning), so global row numbering matches what a
        single engine receiving the same batch would produce."""
        ids = _as_id_list(ids)
        if len(set(ids)) != len(ids):
            raise SchemaError("duplicate ids within one upsert batch")
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if vectors.ndim != 2 or vectors.shape[1] != self.schema.vector.dim:
            raise SchemaError(
                f"expected ({len(ids)}, {self.schema.vector.dim}) vectors, "
                f"got {vectors.shape}")
        if len(vectors) != len(ids):
            raise SchemaError(f"{len(ids)} ids but {len(vectors)} vectors")
        if payloads is None:
            payloads = [None] * len(ids)
        if len(payloads) != len(ids):
            raise SchemaError(f"{len(ids)} ids but {len(payloads)} payloads")
        # validate the WHOLE batch before any shard commits anything
        validated = [self.schema.validate_payload(p) for p in payloads]

        with self._lock:
            self._check_open()
            seq0 = self._next_seq
            for shard, idxs in sorted(self._router.partition(ids).items()):
                view = self._views[shard]
                sub_ids = [ids[i] for i in idxs]
                sub_vecs = vectors[idxs]
                sub_pl = [validated[i] for i in idxs]
                for col in view.replicas:     # writes go to ALL replicas
                    col.upsert(sub_ids, sub_vecs, sub_pl)
                for i in idxs:
                    seq = seq0 + i
                    old = self._seq_of.get(ids[i])
                    if old is not None:       # replaced: old seq retires
                        del self._id_of_seq[old]
                        view.rdict.pop(old, None)
                    self._seq_of[ids[i]] = seq
                    self._id_of_seq[seq] = ids[i]
                    view.gmap.append(seq)     # row-aligned with the engine
                    view.rdict[seq] = len(view.gmap) - 1
            self._next_seq = seq0 + len(ids)
            return len(ids)

    def delete(self, ids: Union[str, Sequence[str]]) -> int:
        n = 0
        with self._lock:
            self._check_open()
            for id_ in _as_id_list(ids):
                seq = self._seq_of.pop(id_, None)
                if seq is None:
                    continue
                del self._id_of_seq[seq]
                view = self._views[self._router.shard_of(id_)]
                view.rdict.pop(seq, None)
                for col in view.replicas:
                    col.delete(id_)
                n += 1
        return n

    def seal(self, shard: Optional[int] = None) -> None:
        """Fold delta segments into the sealed index on one shard (or all)
        without renumbering rows."""
        with self._lock:
            self._check_open()
            for s in self._shard_range(shard):
                for col in self._views[s].replicas:
                    col.seal()

    def compact(self, shard: Optional[int] = None) -> int:
        """Rebuild one shard (or all) over live rows only.  Local rows are
        renumbered but seqs are STABLE: the new `gmap` re-derives each
        surviving row's original seq, so global ids, tie-breaks, and
        already-issued `search` results keep meaning the same entities."""
        reclaimed = 0
        with self._lock:
            self._check_open()
            for s in self._shard_range(shard):
                view = self._views[s]
                dead = 0
                for col in view.replicas:   # lockstep: epochs stay aligned
                    dead = col.compact()
                reclaimed += dead
                live_ids = view.replicas[0].ids()
                gmap = [self._seq_of[i] for i in live_ids]
                rdict = {seq: row for row, seq in enumerate(gmap)}
                self._views[s] = _ShardView(
                    view.replicas, view.health, gmap, rdict,
                    tuple(c.epoch for c in view.replicas), view.rr)
            self._topology_gen += 1
        return reclaimed

    def _shard_range(self, shard: Optional[int]) -> List[int]:  # requires-lock: _lock
        if shard is None:
            return list(range(len(self._views)))
        if not 0 <= shard < len(self._views):
            raise ValueError(f"shard must be in [0, {len(self._views)}), "
                             f"got {shard}")
        return [shard]

    def _check_open(self) -> None:      # requires-lock: _lock
        if self._closed:
            raise CollectionClosed(f"collection {self.name!r} is closed")

    # ------------------------------------------------------------ replication
    def set_replica_health(self, shard: int, replica: int, up: bool) -> None:
        """Mark one replica (un)servable.  Reads route around down
        replicas; writes still apply everywhere (a down replica is slow or
        briefly unreachable, not forgotten)."""
        with self._lock:
            view = self._views[self._shard_range(shard)[0]]
            if not 0 <= replica < len(view.replicas):
                raise ValueError(f"replica must be in "
                                 f"[0, {len(view.replicas)}), got {replica}")
            view.health[replica] = bool(up)

    def _replica_order(self, view: _ShardView, shard: int) -> List[int]:
        """Healthy replica indices, round-robin rotated so concurrent reads
        spread across replicas."""
        n = len(view.replicas)
        start = next(view.rr) % n
        order = [(start + i) % n for i in range(n)]
        healthy = [ri for ri in order if view.health[ri]]
        if not healthy:
            raise ShardUnavailable(
                f"all {n} replica(s) of shard {shard} are marked down")
        return healthy

    def _on_replica(self, view: _ShardView, shard: int, call):
        """Run `call(col)` on the first healthy replica that answers,
        failing over past replicas that raise.  Schema errors are
        deterministic — every replica would refuse identically — so they
        propagate instead of burning the failover budget."""
        last: Optional[BaseException] = None
        for ri in self._replica_order(view, shard):
            try:
                return ri, call(view.replicas[ri])
            except SchemaError:
                raise
            except Exception as e:          # failover to the next replica
                last = e
        raise ShardUnavailable(
            f"all replicas of shard {shard} failed the request") from last

    # ------------------------------------------------------- scatter plumbing
    def _scatter(self, views: List[_ShardView], fn) -> List[Any]:
        if len(views) == 1:
            return [fn(0, views[0])]
        futs = [self._pool.submit(fn, s, v) for s, v in enumerate(views)]
        return [f.result() for f in futs]

    @staticmethod
    def _merge_legs(legs, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-shard (Q, k_s) candidates -> exact global (Q, k) top-k in
        seq space.  Sort key (distance, seq) reproduces the single-engine
        tie-break (ascending row) because seq order IS row order."""
        n_q = legs[0][3].shape[0]
        out_d = np.full((n_q, k), np.inf, dtype=np.float32)
        out_i = np.full((n_q, k), -1, dtype=np.int64)
        for q in range(n_q):
            pairs: List[Tuple[float, int]] = []
            for _s, _ri, view, d, rows, _sec in legs:
                gmap = view.gmap
                for dist, row in zip(d[q], rows[q]):
                    if row < 0 or not np.isfinite(dist):
                        continue
                    pairs.append((float(dist), gmap[int(row)]))
            pairs.sort()
            for slot, (dist, seq) in enumerate(pairs[:k]):
                out_d[q, slot] = dist
                out_i[q, slot] = seq
        return out_d, out_i

    def _make_search_fn(self, views: List[_ShardView], log):
        def search_fn(queries, k, flt=None, params=None):
            def leg(s, view):
                t0 = time.perf_counter()
                ri, (d, rows) = self._on_replica(
                    view, s, lambda col: col._engine_search(
                        queries, k, flt=flt, params=params))
                return s, ri, view, np.atleast_2d(d), np.atleast_2d(rows), \
                    time.perf_counter() - t0
            legs = self._scatter(views, leg)
            log.append({"op": "ann", "shards": [
                {"shard": s, "replica": ri, "seconds": sec}
                for s, ri, _v, _d, _r, sec in legs]})
            return self._merge_legs(legs, k)
        return search_fn

    def _make_sparse_fn(self, views: List[_ShardView], log):
        def sparse_fn(field, text, k, flt=None):
            # phase 1: integer corpus statistics from every shard, summed
            # BEFORE any float division -> global IDF/norms, bit-identical
            # to a single index over the union corpus
            parts = self._scatter(views, lambda s, view: self._on_replica(
                view, s,
                lambda col: col._sparse_term_stats(field, text))[1])
            stats = CorpusStats.aggregate(parts)

            def leg(s, view):
                t0 = time.perf_counter()
                ri, (d, rows) = self._on_replica(
                    view, s, lambda col: col._sparse_search(
                        field, text, k, flt=flt, stats=stats))
                return s, ri, view, d, rows, time.perf_counter() - t0
            legs = self._scatter(views, leg)
            log.append({"op": "sparse", "shards": [
                {"shard": s, "replica": ri, "seconds": sec}
                for s, ri, _v, _d, _r, sec in legs]})
            return self._merge_legs(legs, k)
        return sparse_fn

    class _ScatterEngine:
        """Engine facade for `PlanExecutor`'s rescore stage: candidates
        arrive as seq ids, are routed to their owning shards, exact-rescored
        against full-precision local vectors, and merged exactly."""

        def __init__(self, owner: "ShardedCollection",
                     views: List[_ShardView], log):
            self._owner = owner
            self._views = views
            self._log = log

        def exact_rescore(self, queries, cand_ids, k, mask=None):
            cand_ids = np.asarray(cand_ids, dtype=np.int64)
            n_q, n_c = cand_ids.shape

            def leg(s, view):
                t0 = time.perf_counter()
                local = np.full((n_q, n_c), -1, dtype=np.int64)
                rdict = view.rdict
                for q in range(n_q):
                    for c in range(n_c):
                        seq = int(cand_ids[q, c])
                        if seq >= 0:
                            local[q, c] = rdict.get(seq, -1)
                ri, (d, rows) = self._owner._on_replica(
                    view, s, lambda col: col._rescore_local(
                        queries, local, min(k, n_c)))
                return s, ri, view, d, rows, time.perf_counter() - t0
            legs = self._owner._scatter(self._views, leg)
            self._log.append({"op": "rescore", "shards": [
                {"shard": s, "replica": ri, "seconds": sec}
                for s, ri, _v, _d, _r, sec in legs]})
            return self._owner._merge_legs(legs, k)

    # ----------------------------------------------------------------- reads
    def get(self, id: str) -> Optional[Entity]:
        with self._lock:
            self._check_open()
            if id not in self._seq_of:
                return None
            shard = self._router.shard_of(id)
            view = self._views[shard]
        _ri, ent = self._on_replica(view, shard, lambda col: col.get(id))
        return ent

    def count(self, flt: Optional[Filter] = None) -> int:
        if flt is not None:
            flt = validate_filter(self.schema, flt)
        with self._lock:
            self._check_open()
            views = list(self._views)
        return sum(self._on_replica(v, s, lambda col: col.count(flt))[1]
                   for s, v in enumerate(views))

    def query(self, vector: Optional[np.ndarray] = None) -> Query:
        return Query(self, vector)

    def recommend(self, positives: Sequence[Any],
                  negatives: Sequence[Any] = ()) -> Query:
        return Query(self, recommend_vector(self, positives, negatives))

    def search(self, vectors: np.ndarray, k: int,
               flt: Optional[Filter] = None, ef: Optional[int] = None,
               rescore: Optional[bool] = None,
               expansion_width: Optional[int] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Array API over the scatter-gather path.  Returned ids are GLOBAL
        seq numbers (use `search_ids` for string ids) — exactly the row
        numbers a single engine fed the same upsert stream would return."""
        if flt is not None:
            flt = validate_filter(self.schema, flt)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        plan = QueryPlan(k=k, vector=np.asarray(vectors, np.float32),
                         stages=(AnnStage(k=k, ef=ef,
                                          expansion_width=expansion_width,
                                          filter=flt, rescore=rescore),))
        with self._lock:
            res = self._execute_direct(plan)
        return res.distances, res.ids

    def search_ids(self, vectors: np.ndarray, k: int, **kw
                   ) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            d, seqs = self.search(vectors, k, **kw)
            ids = np.empty(seqs.shape, dtype=object)
            for idx, seq in np.ndenumerate(seqs):
                ids[idx] = (self._id_of_seq.get(int(seq))
                            if seq >= 0 and np.isfinite(d[idx]) else None)
            return d, ids

    # -------------------------------------------------------- plan execution
    def _execute_direct(self, plan: QueryPlan,     # requires-lock: _lock
                        deadline: Optional[float] = None) -> ExecResult:
        self._check_open()
        if not self._seq_of:
            n = len(np.asarray(plan.vector)) if plan.batched else 1
            return ExecResult(
                distances=np.full((n, plan.k), np.inf, dtype=np.float32),
                ids=np.full((n, plan.k), -1, dtype=np.int64),
                stages=[])
        views = list(self._views)
        log: List[Dict[str, Any]] = []
        has_text = bool(self.schema.text_fields())
        executor = PlanExecutor(
            self._make_search_fn(views, log),
            self._ScatterEngine(self, views, log),
            mask=None,     # per-shard legs apply their own liveness masks
            sparse_fn=self._make_sparse_fn(views, log) if has_text else None)
        res = executor.execute(plan, deadline=deadline)
        self._attach_shard_timings(res.stages, log)
        return res

    @staticmethod
    def _attach_shard_timings(reports: List[Dict[str, Any]],
                              log: List[Dict[str, Any]]) -> None:
        """Zip the chronological scatter log onto the executor's stage tree
        (depth-first, prefetch children before later siblings — the order
        stages actually executed)."""
        it = iter(log)

        def walk(stage_list):
            for rep in stage_list:
                for child in rep.get("children") or []:
                    walk(child)
                if rep["stage"] in ("ann", "sparse", "rescore"):
                    entry = next(it, None)
                    if entry is not None and entry["op"] == rep["stage"]:
                        rep["shards"] = entry["shards"]
        walk(reports)

    def _locate_seq(self, seq: int, views: List[_ShardView]
                    ) -> Optional[Tuple[int, _ShardView, int]]:
        for s, view in enumerate(views):
            row = view.rdict.get(seq)
            if row is not None:
                return s, view, row
        return None

    def execute_plan(self, plan: QueryPlan, *, include_vector: bool = False,
                     timeout: float = 120.0, explain: bool = False
                     ) -> Union[List[Hit], List[List[Hit]], PlanExplain]:
        """THE read path, mirroring `Collection.execute_plan`: trivial
        single-vector plans coalesce in the collection-level batcher and
        scatter as aligned waves (lock-free, epoch-validated, retried on
        topology races); everything else scatter-gathers under the
        collection lock."""
        plan = validate_plan(self.schema, plan)
        if plan.trivial and not plan.batched and not explain:
            for _ in range(5):
                try:
                    return self._trivial_query(plan, include_vector, timeout)
                except _ViewChanged:
                    continue
            raise QueryRetriesExhausted(
                f"collection {self.name!r} kept changing topology during "
                f"the query")
        deadline = time.perf_counter() + timeout
        with self._lock:
            res = self._execute_direct(plan, deadline=deadline)
            views = list(self._views)
            if plan.batched:
                hits: Any = [self._hits_row(res.distances[i], res.ids[i],
                                            views, include_vector)
                             for i in range(len(res.ids))]
            else:
                hits = self._hits_row(res.distances[0], res.ids[0],
                                      views, include_vector)
        if explain:
            return PlanExplain(plan=plan_to_dict(plan), stages=res.stages,
                               hits=hits)
        return hits

    def _hits_row(self, d: np.ndarray, seqs: np.ndarray,
                  views: List[_ShardView], include_vector: bool,
                  guard_epochs: bool = False) -> List[Hit]:
        """One query row of merged (distance, seq) candidates -> Hits.
        Direct-path callers hold `_lock` (topology cannot move under them);
        the lock-free trivial path passes `guard_epochs=True` so a compact
        racing the payload fetch surfaces as `_ViewChanged`, never as a
        payload for the wrong row."""
        buckets: Dict[Tuple[int, int], List[Tuple[int, float, int]]] = {}
        slot_of: List[Tuple[int, Tuple[int, int], int]] = []
        for slot, (dist, seq) in enumerate(zip(d, seqs)):
            seq = int(seq)
            if seq < 0 or not np.isfinite(dist):
                continue
            loc = self._locate_seq(seq, views)
            if loc is None:               # deleted mid-plan: drop the slot
                continue
            s, view, row = loc
            ri = self._replica_order(view, s)[0]
            bucket = buckets.setdefault((s, ri), [])
            slot_of.append((slot, (s, ri), len(bucket)))
            bucket.append((slot, float(dist), row))
        fetched = {}
        for (s, ri), bucket in buckets.items():
            view = views[s]
            hits = view.replicas[ri].hits_at(
                np.asarray([b[1] for b in bucket], dtype=np.float32),
                np.asarray([b[2] for b in bucket], dtype=np.int64),
                include_vector,
                epoch=view.epochs[ri] if guard_epochs else None)
            if hits is None:
                if guard_epochs:
                    raise _ViewChanged()    # compact raced the fetch
                hits = [None] * len(bucket)
            fetched[(s, ri)] = hits
        out: List[Hit] = []
        for _slot, key, pos in sorted(slot_of):
            hit = fetched[key][pos]
            if hit is not None:
                out.append(hit)
        return out

    @property
    def batcher(self) -> RequestBatcher:
        """Lazily-started collection-LEVEL serving batcher.

        One coalescing point for the whole sharded collection: every
        flushed batch scatters to all shards in a single aligned wave
        (`_batched_scatter`).  Per-shard batchers would be wrong here —
        a request needs ALL shards to answer, so N independent flush
        cycles make each caller wait for the max over N staggered
        deadlines and fragment concurrent waves into partial batches.
        Creation is locked (parallel first queries must share one worker);
        the hot path stays lock-free."""
        # _batcher only ever goes None -> instance (close() nulls it, but
        # post-close submits fail typed anyway), so a stale fast-path read
        # just falls through to the locked slow path
        batcher = self._batcher  # unguarded-ok: lock-free fast path, re-checked under init lock
        if batcher is None:
            with self._batcher_init_lock:
                if self._closed:  # unguarded-ok: close() flips it holding _batcher_init_lock too
                    raise CollectionClosed(   # don't resurrect past close()
                        f"collection {self.name!r} is closed")
                batcher = self._batcher
                if batcher is None:
                    cfg = self.schema.batcher or BatcherConfig()
                    batcher = RequestBatcher(self._batched_scatter,
                                             max_batch=cfg.max_batch,
                                             max_wait_ms=cfg.max_wait_ms)
                    self._batcher = batcher
        return batcher

    def _batched_scatter(self, queries: np.ndarray, k: int,
                         flt: Optional[Filter] = None,
                         params: Optional[AnnParams] = None,
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """search_fn behind `batcher`: one coalesced batch -> one aligned
        scatter across every shard -> exact (distance, seq) merge.  Runs on
        the batcher worker WITHOUT the collection lock; correctness against
        concurrent compact/rebalance comes from the per-replica epoch check
        after each leg — stale rows raise `_ViewChanged`, which fails the
        whole batch and every coalesced caller retries."""
        views = list(self._views)  # unguarded-ok: snapshot; epochs validated per leg below

        def leg(s, view):
            last: Optional[BaseException] = None
            closed = 0
            order = self._replica_order(view, s)
            for ri in order:
                col = view.replicas[ri]
                try:
                    d, rows = col._engine_search(queries, k, flt=flt,
                                                 params=params)
                except SchemaError:
                    raise               # deterministic: no replica differs
                except CollectionClosed as e:
                    closed += 1         # rebalance swapped this replica out
                    last = e
                    continue
                except Exception as e:  # failover to the next replica
                    last = e
                    continue
                if col.epoch != view.epochs[ri]:
                    raise _ViewChanged()    # compact raced: rows are stale
                return (s, ri, view, np.atleast_2d(d), np.atleast_2d(rows),
                        0.0)
            if closed == len(order):    # whole view is dead, not just down
                raise _ViewChanged() from last
            raise ShardUnavailable(
                f"all replicas of shard {s} failed the search") from last

        legs = self._scatter(views, leg)
        return self._merge_legs(legs, k)

    def _trivial_query(self, plan: QueryPlan, include_vector: bool,
                       timeout: float) -> List[Hit]:
        """Fast path: one plain ANN stage, one query vector, no collection
        lock.  Requests coalesce in the collection-level `batcher`; each
        flushed batch scatters to all shards as ONE aligned wave, so
        concurrent callers share the scatter overhead.  Results come back
        in (distance, seq) space and are re-validated — epoch checks
        inside the scatter, epoch-guarded payload fetch, and a topology-
        generation check bracketing the whole round trip (a rebalance
        renumbers seqs, so even epoch-fresh views could misread stale
        seqs) — a racing compact()/rebalance() surfaces as `_ViewChanged`
        (retried by `execute_plan`), never as wrong ids."""
        if self._closed:  # unguarded-ok: racing close() re-detected via BatcherClosed below
            raise CollectionClosed(f"collection {self.name!r} is closed")
        stage = plan.stages[0]
        params = AnnParams.or_none(ef=stage.ef,
                                   expansion_width=stage.expansion_width,
                                   rescore=stage.rescore)
        gen = self._topology_gen  # unguarded-ok: snapshot; re-checked after the fetch
        try:
            fut = self.batcher.submit(np.asarray(plan.vector, np.float32),
                                      plan.k, flt=stage.filter,
                                      params=params)
            d, seqs = fut.result(timeout=timeout)
        except BatcherClosed as e:
            raise CollectionClosed(
                f"collection {self.name!r} is closed") from e
        views = list(self._views)  # unguarded-ok: snapshot; gen re-checked below
        hits = self._hits_row(d, seqs, views, include_vector,
                              guard_epochs=True)
        if self._topology_gen != gen:  # unguarded-ok: single int read
            raise _ViewChanged()       # seq numbering may have been rebuilt
        return hits

    # ------------------------------------------------------------- rebalance
    def rebalance(self, shards: Optional[int] = None,
                  replicas: Optional[int] = None,
                  snapshot_dir: Optional[str] = None) -> Dict[str, Any]:
        """Re-partition onto `shards` shards x `replicas` replicas (either
        None = keep current).  Snapshot-based: sources are checkpointed,
        restored, and re-upserted under the new even slot map."""
        with self._lock:
            self._check_open()
            new_shards = len(self._views) if shards is None else int(shards)
            router = (self._router if new_shards == len(self._views)
                      else Router.even(new_shards))
            return self._rebuild(router, replicas, snapshot_dir)

    def split(self, shard: int,
              snapshot_dir: Optional[str] = None) -> Dict[str, Any]:
        """Scale-out primitive: half of `shard`'s hash slots (and their
        rows) move to a new shard appended at the end."""
        with self._lock:
            self._check_open()
            self._shard_range(shard)
            return self._rebuild(self._router.split(shard), None,
                                 snapshot_dir)

    def move_slot(self, slot: int, to_shard: int,
                  snapshot_dir: Optional[str] = None) -> Dict[str, Any]:
        """Move one hash slot to another shard (the unit step every larger
        rebalance decomposes into)."""
        with self._lock:
            self._check_open()
            return self._rebuild(self._router.moved(slot, to_shard),
                                 None, snapshot_dir)

    def _rebuild(self, router: Router,            # requires-lock: _lock
                 replicas: Optional[int],
                 snapshot_dir: Optional[str]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        n_replicas = (len(self._views[0].replicas) if replicas is None
                      else int(replicas))
        if not 1 <= n_replicas <= CollectionSchema.MAX_REPLICAS:
            raise ValueError(f"replicas must be in "
                             f"[1, {CollectionSchema.MAX_REPLICAS}], "
                             f"got {n_replicas}")
        tmp = None
        if snapshot_dir is None:
            tmp = tempfile.mkdtemp(prefix="quantixar-rebalance-")
            snapshot_dir = tmp
        old_views = self._views
        try:
            # 1. snapshot every source shard through its OWN store (the
            #    ShardedCheckpoint layout — one store per shard keeps the
            #    per-store generation GC from eating sibling snapshots);
            #    this is the artifact a cross-node move would ship, the
            #    gmap riding in the manifest
            stores = [CheckpointStore(os.path.join(snapshot_dir,
                                                   f"shard-{s:04d}"))
                      for s in range(len(old_views))]
            gens = []
            for s, view in enumerate(old_views):
                gens.append(stores[s].save(
                    view.replicas[0].state_dict(), shard_id=s,
                    num_shards=len(old_views),
                    extra={"collection": self.schema.name, "shard": s,
                           "gmap": [int(x) for x in view.gmap]}))
            # 2. restore from the snapshots (NOT the live shards) and
            #    order every live row by its global seq
            entries: List[Tuple[int, str, np.ndarray, Dict[str, Any]]] = []
            for s, gen in enumerate(gens):
                state = stores[s].load(gen)
                gmap = stores[s].manifest(gen).extra["gmap"]
                restored = Collection.from_state_dict(
                    self._shard_schema(s, 0), state, device=self.device)
                try:
                    for row, (id_, alive) in enumerate(
                            zip(state["__ids__"], state["__live__"])):
                        if not alive:
                            continue
                        ent = restored.get(str(id_))
                        entries.append((int(gmap[row]), str(id_),
                                        ent.vector, ent.payload))
                finally:
                    restored.close()
            entries.sort(key=lambda e: e[0])
            # 3. build the new shard set; fresh compact seqs 0..n-1 in the
            #    old global order keep tie-breaks identical to a
            #    single-engine compact()
            self.schema = dataclasses.replace(
                self.schema, shards=router.num_shards, replicas=n_replicas)
            new_views = [self._make_shard(s, n_replicas)
                         for s in range(router.num_shards)]
            seq_of: Dict[str, int] = {}
            id_of_seq: Dict[int, str] = {}
            per_shard: Dict[int, List[int]] = {}
            for seq, (_old_seq, id_, _v, _p) in enumerate(entries):
                seq_of[id_] = seq
                id_of_seq[seq] = id_
                per_shard.setdefault(router.shard_of(id_), []).append(seq)
            for s, seqs in sorted(per_shard.items()):
                view = new_views[s]
                ids = [entries[q][1] for q in seqs]
                vecs = np.stack([entries[q][2] for q in seqs])
                pls = [entries[q][3] for q in seqs]
                for col in view.replicas:
                    col.upsert(ids, vecs, pls)
                view.gmap.extend(seqs)
                for row, seq in enumerate(seqs):
                    view.rdict[seq] = row
            # 4. swap; in-flight batcher-path queries hit CollectionClosed
            #    on the old replicas and retry against the new views
            self._router = router
            self._views = new_views
            self._seq_of = seq_of
            self._id_of_seq = id_of_seq
            self._next_seq = len(entries)
            self._topology_gen += 1
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        for view in old_views:
            for col in view.replicas:
                col.close()
        return {"shards": router.num_shards, "replicas": n_replicas,
                "rows": len(self._seq_of),
                "seconds": time.perf_counter() - t0}

    # --------------------------------------------------------------- service
    def close(self) -> None:
        # lock order: _lock, then _batcher_init_lock — mirrors `Collection`
        # so the traced-lock graph stays acyclic; holding both means the
        # batcher property and direct-path queries each see _closed flip
        # atomically
        with self._lock:
            with self._batcher_init_lock:
                if self._closed:
                    return
                self._closed = True
                batcher, self._batcher = self._batcher, None
            views = self._views
        self._pool.shutdown(wait=False)
        # join the batcher worker outside the sharded lock (it takes only
        # the per-shard collections' locks)
        if batcher is not None:
            batcher.close()
        for view in views:
            for col in view.replicas:
                col.close()

    def stats(self) -> Dict[str, Any]:
        per = self.shard_stats()
        agg: Dict[str, Any] = {
            "name": self.name,
            "shards": len(per),
            "replicas": self.schema.replicas,
            "hash_slots": HASH_SLOTS,
            "n": sum(p["rows"] for p in per),
            "live": sum(p["live"] for p in per),
            "tombstones": sum(p["tombstones"] for p in per),
            "per_shard": per,
        }
        # serving counters come from the collection-level batcher (the
        # trivial-query coalescing point); snapshot the attribute — a
        # concurrent close() may null it between the check and the call
        batcher = self._batcher  # unguarded-ok: atomic snapshot; batcher.stats() is safe post-close
        serving = (batcher.stats() if batcher is not None
                   else RequestBatcher.zero_stats())
        agg.update({f"serving_{k}": v for k, v in serving.items()})
        agg["serving_queue_depth"] += sum(p["queue_depth"] for p in per)
        return agg

    def shard_stats(self) -> List[Dict[str, Any]]:
        """Per-shard rows/tombstones/queue depth + routing and health —
        the payload behind the wire `ShardStats` op."""
        with self._lock:
            self._check_open()
            views = list(self._views)
            router = self._router
        out = []
        for s, view in enumerate(views):
            reps = [col.shard_stats()[0] for col in view.replicas]
            out.append({
                "shard": s,
                "replicas": len(view.replicas),
                "rows": reps[0]["rows"],
                "live": reps[0]["live"],
                "tombstones": reps[0]["tombstones"],
                "queue_depth": sum(r["queue_depth"] for r in reps),
                "slots": router.slots_of_shard(s),
                "health": [bool(h) for h in view.health],
            })
        return out

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Flat array state: routing table + per-shard sub-states (replica
        0 only — replicas are bit-identical and re-fan-out on load)."""
        with self._lock:
            state: Dict[str, np.ndarray] = {
                "__cluster__slot_map": np.asarray(self._router.slot_map,
                                                  dtype=np.int64),
                "__cluster__next_seq": np.asarray([self._next_seq],
                                                  dtype=np.int64),
            }
            for s, view in enumerate(self._views):
                state[f"__cluster__gmap{s}"] = np.asarray(view.gmap,
                                                          dtype=np.int64)
                for key, arr in view.replicas[0].state_dict().items():
                    state[f"__cluster__shard{s}__{key}"] = arr
            return state

    @classmethod
    def from_state_dict(cls, schema: CollectionSchema,
                        state: Dict[str, np.ndarray],
                        device="cuda") -> "ShardedCollection":
        obj = cls.__new__(cls)
        obj.schema = schema
        obj.device = resolve_device(device)
        obj._router = Router(
            [int(x) for x in state["__cluster__slot_map"]])
        obj._next_seq = int(state["__cluster__next_seq"][0])
        obj._seq_of = {}
        obj._id_of_seq = {}
        obj._views = []
        obj._closed = False
        obj._scatter_log = []
        obj._pool = ThreadPoolExecutor(max_workers=16,
                                       thread_name_prefix="qx-shard")
        obj._lock = threading.RLock()
        obj._batcher = None
        obj._batcher_init_lock = threading.Lock()
        obj._topology_gen = 0
        for s in range(obj._router.num_shards):
            prefix = f"__cluster__shard{s}__"
            sub = {k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix)}
            gmap = [int(x) for x in state[f"__cluster__gmap{s}"]]
            replicas = []
            for r in range(schema.replicas):
                # replicas must not alias each other's arrays: each engine
                # mutates its own copies as writes land post-load
                rsub = (sub if r == 0 else
                        {k: np.array(v, copy=True) for k, v in sub.items()})
                replicas.append(Collection.from_state_dict(
                    obj._shard_schema(s, r), rsub, device=obj.device))
            rdict: Dict[int, int] = {}
            for row, (id_, alive) in enumerate(
                    zip(sub["__ids__"], sub["__live__"])):
                if not alive:
                    continue
                seq = gmap[row]
                obj._seq_of[str(id_)] = seq
                obj._id_of_seq[seq] = str(id_)
                rdict[seq] = row
            obj._views.append(_ShardView(
                tuple(replicas), [True] * schema.replicas, gmap, rdict,
                tuple(c.epoch for c in replicas)))
        return obj
