"""`Collection`: schema-driven entity store over a `QuantixarEngine`.

The engine speaks positional row ids over an append-only corpus; the
collection owns the mapping to stable string ids with `upsert`/`get`/
`delete` semantics:

  * upsert of an existing id tombstones the old row and appends a new one
    (HNSW is build-once, so in-place mutation is not possible);
  * deletes are tombstones — dead rows stay in the index but are masked out
    of every search via the engine's row-mask hook;
  * `compact()` rebuilds the engine from live rows only, reclaiming the
    space and graph quality lost to tombstones.

Every read goes through ONE execution path: the fluent `Query` (and the
legacy `search`/`search_ids` array API) compiles to a declarative
`QueryPlan` which `execute_plan` runs — trivial single-vector plans
coalesce through the per-collection `RequestBatcher` into padded engine
batches, everything else (2-D batches, multi-stage coarse-to-fine plans,
prefetch + fusion, `explain`) executes under the collection lock via the
staged `PlanExecutor`.

Carried across from the JAX package's ``repro.api.collection``: the only
change is the torch ``device`` the collection's engine runs on, the card
unless the caller asks for the CPU (``Collection(schema, device=...)``,
``from_state_dict(..., device=...)``); `compact()` rebuilds on the same
device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.engine import QuantixarEngine
from ..core.executor import AnnParams, ExecResult, PlanExecutor
from ..core.metadata import Filter
from ..core.sparse import SparseIndex
from ..serving.batcher import RequestBatcher
from .plan import (AnnStage, PlanExplain, QueryPlan, plan_to_dict,
                   recommend_vector, validate_filter, validate_plan)
from .query import Hit, Query
from .schema import BatcherConfig, CollectionSchema, SchemaError


@dataclasses.dataclass
class Entity:
    """One stored entity: string id, vector, validated payload."""

    id: str
    vector: np.ndarray
    payload: Dict[str, Any]


class CollectionClosed(RuntimeError):
    """Query raced close()/drop: the batcher is gone and must not be
    resurrected.  Typed so the service plane maps it to UNAVAILABLE."""


class QueryRetriesExhausted(RuntimeError):
    """Every retry of a batched query was invalidated by a concurrent
    compact(); the caller saw no stale data, just no answer — retryable."""


def _as_id_list(ids: Union[str, Sequence[str]]) -> List[str]:
    ids = [ids] if isinstance(ids, str) else list(ids)
    for i in ids:
        if not isinstance(i, str) or not i:
            raise SchemaError(f"ids must be non-empty strings, got {i!r}")
    return ids


class Collection:
    def __init__(self, schema: CollectionSchema, device="cuda"):
        self.schema = schema
        self._engine = QuantixarEngine(     # guarded-by: _lock
            schema.vector.to_engine_config(), device=device)
        self.device = self._engine.device
        # one BM25 inverted index per TextField, row-aligned with the engine
        self._sparse = {f.name: SparseIndex(f.tokenizer())  # guarded-by: _lock
                        for f in schema.text_fields()}
        self._ids: List[str] = []        # guarded-by: _lock (row -> id)
        self._live: List[bool] = []      # guarded-by: _lock (row liveness)
        self._row_of: Dict[str, int] = {}   # guarded-by: _lock (live id->row)
        self._batcher: Optional[RequestBatcher] = None  # guarded-by: _batcher_init_lock
        self._batcher_init_lock = threading.Lock()
        # close() holds BOTH locks while flipping this, so a reader under
        # either lock observes the final value
        self._closed = False    # guarded-by: _lock|_batcher_init_lock
        self._mask: Optional[np.ndarray] = None   # guarded-by: _lock
        self._epoch = 0        # guarded-by: _lock (compact renumbers rows)
        # one engine is shared between caller threads (2-D queries, writes)
        # and the batcher worker (1-D queries); its lazy rebuild and chunk
        # concatenation are not thread-safe, so serialize around it
        self._lock = threading.RLock()

    # ------------------------------------------------------------ properties
    @property
    def name(self) -> str:
        return self.schema.name

    def __len__(self) -> int:
        """Number of live entities."""
        with self._lock:
            return len(self._row_of)

    @property
    def tombstones(self) -> int:
        """Dead rows still occupying the index (reclaim via `compact()`)."""
        with self._lock:
            return len(self._ids) - len(self._row_of)

    def __contains__(self, id: str) -> bool:
        with self._lock:
            return id in self._row_of

    @property
    def epoch(self) -> int:
        """Row-numbering generation: bumped by every `compact()` that drops
        tombstones.  Callers that translate engine rows outside the lock
        (the batcher path, shard scatter-gather) snapshot this before the
        search and re-check it before trusting the row numbers."""
        with self._lock:
            return self._epoch

    def ids(self) -> List[str]:
        """Live ids in insertion order."""
        with self._lock:
            return [i for i, alive in zip(self._ids, self._live) if alive]

    # ---------------------------------------------------------------- writes
    def upsert(self, ids: Union[str, Sequence[str]],
               vectors: np.ndarray,
               payloads: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
               ) -> int:
        """Insert or replace entities by string id.  Returns rows written.

        Payloads are validated against the schema (typed fields, required
        fields, unknown-key rejection) before anything is stored.
        """
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
        # validate everything before mutating anything
        validated = [self.schema.validate_payload(p) for p in payloads]

        with self._lock:
            row0 = len(self._ids)
            self._engine.add(vectors, validated)
            for name, index in self._sparse.items():
                # one entry per row (None for rows without the field) keeps
                # sparse row ids aligned with engine rows
                index.add([p.get(name) for p in validated])
            for off, id_ in enumerate(ids):
                old = self._row_of.pop(id_, None)
                if old is not None:
                    self._live[old] = False      # replaced -> tombstone
                self._ids.append(id_)
                self._live.append(True)
                self._row_of[id_] = row0 + off
            self._mask = None
            return len(ids)

    def delete(self, ids: Union[str, Sequence[str]]) -> int:
        """Tombstone entities by id; unknown ids are ignored.  Returns the
        number actually deleted."""
        n = 0
        with self._lock:
            for id_ in _as_id_list(ids):
                row = self._row_of.pop(id_, None)
                if row is not None:
                    self._live[row] = False
                    n += 1
            self._mask = None
        return n

    def seal(self) -> None:
        """Fold the engine's delta segment into the sealed index and seal
        every sparse index — `compact()`'s no-tombstone fast path, exposed
        so shard owners can merge segments without a row renumber."""
        with self._lock:
            self._engine.seal()
            for index in self._sparse.values():
                index.seal()

    def compact(self) -> int:
        """Rebuild the engine over live rows only (drops tombstones, restores
        graph quality).  Returns the number of rows reclaimed.

        With no tombstones to reclaim this still folds the engine's delta
        segment into the sealed index (`QuantixarEngine.seal()`), so
        `compact()` doubles as the explicit merge hook of the segmented
        write path."""
        with self._lock:
            dead = self.tombstones
            if dead == 0:
                self._engine.seal()
                for index in self._sparse.values():
                    index.seal()
                return 0
            live_rows = [r for r, alive in enumerate(self._live) if alive]
            vectors = self._engine.vectors[live_rows]
            payloads = [self._engine.metadata.record(r) for r in live_rows]
            live_ids = [self._ids[r] for r in live_rows]

            self._engine = QuantixarEngine(
                self.schema.vector.to_engine_config(), device=self.device)
            # text payloads ride in the metadata records, so re-upserting
            # rebuilds the sparse indexes over live rows automatically
            self._sparse = {f.name: SparseIndex(f.tokenizer())
                            for f in self.schema.text_fields()}
            self._ids, self._live, self._row_of = [], [], {}
            self._mask = None
            self._epoch += 1   # all row numbers just changed
            if live_ids:
                self.upsert(live_ids, vectors, payloads)
            return dead

    # ----------------------------------------------------------------- reads
    def get(self, id: str) -> Optional[Entity]:
        with self._lock:
            row = self._row_of.get(id)
            if row is None:
                return None
            return Entity(id=id, vector=self._engine.vectors[row].copy(),
                          payload=self._engine.metadata.record(row))

    def query(self, vector: Optional[np.ndarray] = None) -> Query:
        """Start a fluent query: `col.query(v).filter(...).top_k(5).run()`.
        With no vector, chain `.text("...")` for a pure keyword (BM25)
        search; with both, the query fuses dense + sparse (hybrid)."""
        return Query(self, vector)

    def recommend(self, positives: Sequence[Any],
                  negatives: Sequence[Any] = ()) -> Query:
        """Start a fluent query whose vector is synthesized from example
        entities (ids or raw vectors): mean(positives) - mean(negatives)."""
        return Query(self, recommend_vector(self, positives, negatives))

    def count(self, flt: Optional[Filter] = None) -> int:
        """Filtered cardinality: live entities matching `flt` (all live
        entities when None) — no hits fetched, no vector work."""
        if flt is not None:
            flt = validate_filter(self.schema, flt)
        with self._lock:
            if self._closed:
                raise CollectionClosed(
                    f"collection {self.name!r} is closed")
            if flt is None or len(self._row_of) == 0:
                # empty collection: nothing matches — don't let the
                # metadata store raise on columns it has never seen
                return len(self._row_of)
            mask = self._engine.metadata.evaluate(flt)
            live = self._live_mask()
            if live is not None:
                mask = mask & live
            return int(np.asarray(mask, dtype=bool).sum())

    def search(self, vectors: np.ndarray, k: int,
               flt: Optional[Filter] = None, ef: Optional[int] = None,
               rescore: Optional[bool] = None,
               expansion_width: Optional[int] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Engine-level batch search with tombstones masked out.  Returns
        (distances, rows) — use `query()` for string-id `Hit` results.

        Compiles to a trivial single-stage plan, so the array API runs the
        same execution path as the fluent/wire queries.  An empty
        collection answers with the engine's padding convention (all-inf
        distances, row -1) instead of raising, so shard fan-outs and the
        serving plane see "no results", not an error."""
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
        """Like `search` but returns string ids (object array; None = empty
        slot) — the shape shard fan-out / cross-collection merges consume."""
        with self._lock:
            d, rows = self.search(vectors, k, **kw)
            ids = np.empty(rows.shape, dtype=object)
            for idx, row in np.ndenumerate(rows):
                # inf distance = padded/masked slot the engine only
                # demoted; its row number must not leak out as a real id
                ids[idx] = (self._ids[int(row)]
                            if row >= 0 and np.isfinite(d[idx]) else None)
            return d, ids

    # ------------------------------------------------------------- internals
    def _live_mask(self) -> Optional[np.ndarray]:  # requires-lock: _lock
        if self.tombstones == 0:
            return None
        if self._mask is None:        # invalidated by every write
            self._mask = np.asarray(self._live, dtype=bool)
        return self._mask

    def _engine_search(self, queries, k, flt=None,
                       params: Optional[AnnParams] = None):
        """One masked first-pass engine search — the ANN primitive both the
        serving batcher and the plan executor call.  Per-query knobs arrive
        as a single `AnnParams` struct instead of parallel keyword lists."""
        with self._lock:
            if len(self._row_of) == 0:
                # empty collection = empty result, not an error: pad with
                # the engine's masked-slot convention (inf distance, row -1)
                if k < 1:
                    raise ValueError(f"k must be >= 1, got {k}")
                n = 1 if queries.ndim == 1 else len(queries)
                return (np.full((n, k), np.inf, dtype=np.float32),
                        np.full((n, k), -1, dtype=np.int64))
            k = min(k, len(self._row_of))
            return self._engine.search(queries, k, flt=flt,
                                       mask=self._live_mask(),
                                       params=params)

    def _sparse_search(self, field: str, text: str, k: int,
                       flt: Optional[Filter] = None, stats=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """One masked BM25 pass over a text field's inverted index — the
        sparse twin of `_engine_search`.  Returns (1, k) padded candidate
        arrays whose distances are negated BM25 scores (lower = better).
        `stats` substitutes shard-aggregated corpus statistics so a
        scattered search scores with global IDF/norms, not local ones."""
        with self._lock:
            index = self._sparse.get(field)
            if index is None:       # validate_plan resolves fields first
                raise SchemaError(f"collection {self.name!r} has no text "
                                  f"field {field!r}")
            mask = self._live_mask()
            if flt is not None:
                fmask = self._engine.metadata.evaluate(flt)
                mask = fmask if mask is None else (mask & fmask)
            d, rows = index.search(text, k, mask=mask, stats=stats)
            return d[None, :], rows[None, :]

    def _sparse_term_stats(self, field: str, text: str):
        """Local corpus statistics `(docs_with_text, total_tokens, df)` for
        the query's tokens — the gather leg of distributed BM25
        (`CorpusStats.aggregate` sums these across shards)."""
        with self._lock:
            index = self._sparse.get(field)
            if index is None:
                raise SchemaError(f"collection {self.name!r} has no text "
                                  f"field {field!r}")
            return index.term_stats(index.config.tokenize(text))

    def _rescore_local(self, queries: np.ndarray, rows: np.ndarray, k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-rescore a candidate row set against full-precision vectors
        (tombstones masked) — the per-shard leg of a scattered rescore."""
        with self._lock:
            return self._engine.exact_rescore(queries, rows, k,
                                              mask=self._live_mask())

    def _execute_direct(self, plan: QueryPlan,  # requires-lock: _lock
                        deadline: Optional[float] = None) -> ExecResult:
        """Run a plan through the staged executor (caller holds the lock)."""
        if self._closed:
            # parity with the batcher path: a dropped collection must
            # refuse direct-path queries too, not serve its stale engine
            raise CollectionClosed(f"collection {self.name!r} is closed")
        if len(self._row_of) == 0:
            n = len(np.asarray(plan.vector)) if plan.batched else 1
            return ExecResult(
                distances=np.full((n, plan.k), np.inf, dtype=np.float32),
                ids=np.full((n, plan.k), -1, dtype=np.int64),
                stages=[])
        executor = PlanExecutor(self._engine_search, self._engine,
                                mask=self._live_mask(),
                                sparse_fn=(self._sparse_search
                                           if self._sparse else None))
        return executor.execute(plan, deadline=deadline)

    @property
    def batcher(self) -> RequestBatcher:
        """Lazily-started serving batcher (single-vector query path); its
        batch size/deadline come from the schema's `BatcherConfig`.

        Creation is locked — concurrent first queries (e.g. parallel HTTP
        threads) must share one batcher, not leak a second worker whose
        counters and requests vanish — but the hot path stays lock-free so
        submits keep enqueueing while the worker (which takes the collection
        lock to search) is mid-batch."""
        # _batcher only ever goes None -> instance (close() nulls it, but
        # post-close submits fail typed anyway), so a stale fast-path read
        # just falls through to the locked slow path
        batcher = self._batcher  # unguarded-ok: lock-free fast path, re-checked under init lock
        if batcher is None:
            with self._batcher_init_lock:
                if self._closed:     # don't resurrect past close()/drop —
                    raise CollectionClosed(   # that leaks a worker thread
                        f"collection {self.name!r} is closed")
                batcher = self._batcher
                if batcher is None:
                    cfg = self.schema.batcher or BatcherConfig()
                    batcher = RequestBatcher(self._engine_search,
                                             max_batch=cfg.max_batch,
                                             max_wait_ms=cfg.max_wait_ms)
                    self._batcher = batcher
        return batcher

    def _hits_for(self, d: np.ndarray, rows: np.ndarray,
                  include_vector: bool) -> List[Hit]:
        hits = []
        with self._lock:
            for dist, row in zip(d, rows):
                row = int(row)
                if row < 0 or not np.isfinite(dist):
                    continue                    # padded / masked-out slot
                hits.append(Hit(
                    id=self._ids[row], score=float(dist),
                    payload=self._engine.metadata.record(row),
                    vector=(self._engine.vectors[row].copy()
                            if include_vector else None)))
        return hits

    def hits_at(self, d: np.ndarray, rows: np.ndarray,
                include_vector: bool = False, *,
                epoch: Optional[int] = None) -> Optional[List[Optional[Hit]]]:
        """Position-preserving row->Hit translation: one entry per input
        slot, `None` where the slot is padded/masked.  With `epoch` given,
        returns `None` (whole call) if a compact() renumbered rows since the
        caller snapshotted that epoch — the shard scatter-gather path
        retries instead of serving hits for the wrong entities."""
        out: List[Optional[Hit]] = []
        with self._lock:
            if epoch is not None and self._epoch != epoch:
                return None
            for dist, row in zip(d, rows):
                row = int(row)
                if row < 0 or not np.isfinite(dist):
                    out.append(None)
                    continue
                out.append(Hit(
                    id=self._ids[row], score=float(dist),
                    payload=self._engine.metadata.record(row),
                    vector=(self._engine.vectors[row].copy()
                            if include_vector else None)))
        return out

    def execute_plan(self, plan: QueryPlan, *, include_vector: bool = False,
                     timeout: float = 120.0, explain: bool = False
                     ) -> Union[List[Hit], List[List[Hit]], PlanExplain]:
        """THE read path: every query — fluent builder, wire `Search` op,
        legacy array API — arrives here as a declarative plan.

        Trivial single-vector plans (one plain ANN stage) coalesce through
        the serving batcher; batches, multi-stage plans, and `explain`
        execute directly via the staged `PlanExecutor` under the collection
        lock.  `timeout` bounds queue-wait on the batcher path and is
        enforced at stage boundaries on the direct path (an in-flight
        stage itself is not interrupted).  With `explain=True` the result
        is a `PlanExplain` carrying the compiled plan, per-stage candidate
        counts/timings, and hits."""
        plan = validate_plan(self.schema, plan)
        if plan.trivial and not plan.batched and not explain:
            # single query: coalesce through the serving batcher.  The
            # future resolves outside the lock, so a concurrent compact()
            # could renumber rows before translation — detect via the epoch
            # and retry.
            stage = plan.stages[0]
            vec = np.asarray(plan.vector, dtype=np.float32)
            params = AnnParams.or_none(ef=stage.ef,
                                       expansion_width=stage.expansion_width,
                                       rescore=stage.rescore)
            for _ in range(5):
                epoch = self._epoch  # unguarded-ok: optimistic read, re-validated under _lock below
                fut = self.batcher.submit(vec, plan.k, flt=stage.filter,
                                          params=params)
                d, rows = fut.result(timeout=timeout)
                with self._lock:
                    if self._epoch == epoch:
                        return self._hits_for(d, rows, include_vector)
            raise QueryRetriesExhausted(
                f"collection {self.name!r} kept compacting during the query")
        deadline = time.perf_counter() + timeout
        with self._lock:   # rows stay valid until translated to ids
            res = self._execute_direct(plan, deadline=deadline)
            if plan.batched:
                hits: Any = [self._hits_for(res.distances[i], res.ids[i],
                                            include_vector)
                             for i in range(len(res.ids))]
            else:
                hits = self._hits_for(res.distances[0], res.ids[0],
                                      include_vector)
        if explain:
            return PlanExplain(plan=plan_to_dict(plan), stages=res.stages,
                               hits=hits)
        return hits

    def close(self) -> None:
        # lock order: _lock, then _batcher_init_lock (the traced-lock fuzz
        # harness checks this graph stays acyclic; no path acquires them in
        # the reverse order while holding the first).  Holding both means
        # direct-path queries (under _lock) and batcher resurrection (under
        # _batcher_init_lock) each see _closed flip atomically.
        with self._lock:
            with self._batcher_init_lock:
                self._closed = True
                batcher, self._batcher = self._batcher, None
        # join the worker outside both locks: it takes _lock to search
        if batcher is not None:
            batcher.close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = self._engine.stats()
            out.update({"name": self.name, "live": len(self),
                        "tombstones": self.tombstones})
            sparse_agg = [idx.stats() for idx in self._sparse.values()]
        # serving counters: all-zero until the batcher path first runs.
        # snapshot the attribute — a concurrent close() may null it between
        # the check and the call
        batcher = self._batcher  # unguarded-ok: atomic snapshot; batcher.stats() is safe post-close
        serving = (batcher.stats() if batcher is not None
                   else RequestBatcher.zero_stats())
        out.update({f"serving_{k}": v for k, v in serving.items()})
        if sparse_agg:
            agg = sparse_agg
            out.update({
                "sparse_fields": len(agg),
                "sparse_docs_indexed": sum(s["docs_indexed"] for s in agg),
                "sparse_vocab": sum(s["vocab"] for s in agg),
                "sparse_postings": sum(s["postings"] for s in agg),
                "sparse_sealed_postings": sum(s["sealed_postings"]
                                              for s in agg),
                "sparse_delta_postings": sum(s["delta_postings"]
                                             for s in agg),
                "sparse_seals": sum(s["seals"] for s in agg),
            })
        return out

    def shard_stats(self) -> List[Dict[str, Any]]:
        """Per-shard breakdown; a plain collection is one shard of one
        replica, so the wire `ShardStats` op answers uniformly."""
        with self._lock:
            rows = len(self._ids)
            live = len(self._row_of)
        batcher = self._batcher  # unguarded-ok: atomic snapshot; batcher.stats() is safe post-close
        depth = (batcher.stats()["queue_depth"] if batcher is not None else 0)
        return [{"shard": 0, "replicas": 1, "rows": rows, "live": live,
                 "tombstones": rows - live, "queue_depth": depth,
                 "slots": None}]

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, np.ndarray]:
        with self._lock:
            state = dict(self._engine.state_dict())
            state["__ids__"] = np.asarray(self._ids, dtype=object)
            state["__live__"] = np.asarray(self._live, dtype=bool)
            # "__sparse__" prefix keeps these out of the engine sub-state;
            # the packed form preserves the sealed/delta split, so a
            # loaded index keeps absorbing upserts without a rebuild
            for name, index in self._sparse.items():
                for key, arr in index.state_dict().items():
                    state[f"__sparse__{name}/{key}"] = arr
            return state

    @classmethod
    def from_state_dict(cls, schema: CollectionSchema,
                        state: Dict[str, np.ndarray],
                        device="cuda") -> "Collection":
        col = cls.__new__(cls)
        col.schema = schema
        engine_state = {k: v for k, v in state.items()
                        if not k.startswith("__")}
        col._engine = QuantixarEngine.from_state_dict(
            schema.vector.to_engine_config(), engine_state, device=device)
        col.device = col._engine.device
        sparse_state: Dict[str, Dict[str, np.ndarray]] = {}
        for key, arr in state.items():
            if key.startswith("__sparse__"):
                # index state keys carry no "/", so the last one separates
                # the field name from the array key
                name, sub = key[len("__sparse__"):].rsplit("/", 1)
                sparse_state.setdefault(name, {})[sub] = arr
        col._sparse = {}
        for fld in schema.text_fields():
            if fld.name in sparse_state:
                col._sparse[fld.name] = SparseIndex.from_state_dict(
                    sparse_state[fld.name], fld.tokenizer())
            else:
                # checkpoint predates the field (or was written without the
                # index): rebuild from the metadata records once, here
                index = SparseIndex(fld.tokenizer())
                records = col._engine.metadata
                index.add([records.record(r).get(fld.name)
                           for r in range(len(records))])
                col._sparse[fld.name] = index
        col._ids = [str(i) for i in state["__ids__"]]
        col._live = [bool(b) for b in state["__live__"]]
        col._row_of = {i: r for r, (i, alive)
                       in enumerate(zip(col._ids, col._live)) if alive}
        col._batcher = None
        col._batcher_init_lock = threading.Lock()
        col._closed = False
        col._mask = None
        col._epoch = 0
        col._lock = threading.RLock()
        return col
