"""`QuantixarService`: the transport-agnostic request plane over a Database.

One service instance owns one `Database` and turns wire-protocol requests
(`repro_torch.api.requests`) into typed responses:

  * dispatch is a pure function of the request dataclass — the HTTP server,
    an in-process test harness, or any future transport all call
    `dispatch()` and get back a `Response` or an `ErrorInfo`, never a raw
    exception;
  * single-vector searches flow through each collection's `RequestBatcher`
    (via the fluent `Query` path), so concurrent wire requests coalesce into
    padded engine batches without any caller touching `.batcher`;
  * every internal failure is mapped onto the structured error taxonomy
    (SCHEMA_ERROR / NOT_FOUND / INVALID_ARGUMENT / UNAVAILABLE / INTERNAL).

Snapshot/Restore round-trip the whole database through the checkpoint
store: `Restore` atomically swaps the served `Database` for the one loaded
from disk.

Carried across from the JAX package's ``repro.serving.service``; the one
change is the torch ``device``: a service that makes its own `Database`
makes it on ``QuantixarService(device=...)``, the card unless the caller
asks for the CPU, and `Restore` loads onto the served database's device.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple, Type, Union

import numpy as np

from ..api import requests as rq
from ..api.collection import CollectionClosed, QueryRetriesExhausted
from ..api.database import Database
from ..api.plan import plan_from_dict
from ..api.query import Hit
from ..api.schema import BatcherConfig, CollectionSchema, SchemaError
from ..cluster.sharded import ShardedCollection, ShardUnavailable
from .batcher import BatcherClosed


@dataclasses.dataclass
class ServiceConfig:
    """Service-plane knobs, applied on top of per-collection schemas."""

    # batcher defaults for collections whose schema doesn't specify one
    default_max_batch: int = 32
    default_max_wait_ms: float = 2.0
    # bound on how long one search request may sit in the serving queue
    query_timeout_s: float = 60.0

    def default_batcher(self) -> BatcherConfig:
        return BatcherConfig(max_batch=self.default_max_batch,
                             max_wait_ms=self.default_max_wait_ms)


def to_error_info(exc: BaseException) -> rq.ErrorInfo:
    """Internal exception -> structured taxonomy entry.  The order matters:
    `ApiError` carries its own info; `SchemaError` is a ValueError subclass
    so it must be tested before the generic INVALID_ARGUMENT bucket."""
    if isinstance(exc, rq.ApiError):
        return exc.info
    if isinstance(exc, SchemaError):
        return rq.ErrorInfo(rq.SCHEMA_ERROR, str(exc))
    if isinstance(exc, KeyError):
        # NOT a not-found: genuine lookups are wrapped at their call sites
        # (`_col`, drop).  A bare KeyError here is a malformed body — e.g. a
        # schema dict without "name" or a filter node missing "column".
        missing = exc.args[0] if exc.args else exc
        return rq.ErrorInfo(rq.INVALID_ARGUMENT,
                            f"missing required key {missing!r}")
    if isinstance(exc, FileNotFoundError):
        return rq.ErrorInfo(rq.NOT_FOUND, str(exc))
    if isinstance(exc, TimeoutError):
        return rq.ErrorInfo(rq.UNAVAILABLE, str(exc) or "request timed out")
    # shutdown / compaction churn / a shard with no healthy replicas:
    # transient, the caller should retry
    if isinstance(exc, (BatcherClosed, CollectionClosed,
                        QueryRetriesExhausted, ShardUnavailable)):
        return rq.ErrorInfo(rq.UNAVAILABLE, str(exc))
    if isinstance(exc, RuntimeError):
        return rq.ErrorInfo(rq.INTERNAL, str(exc))
    if isinstance(exc, (ValueError, TypeError)):
        return rq.ErrorInfo(rq.INVALID_ARGUMENT, str(exc))
    return rq.ErrorInfo(rq.INTERNAL,
                        f"{type(exc).__name__}: {exc}")


def _hit_to_dict(hit: Hit) -> Dict[str, Any]:
    out: Dict[str, Any] = {"id": hit.id, "score": float(hit.score),
                           "payload": hit.payload}
    if hit.vector is not None:
        out["vector"] = np.asarray(hit.vector, dtype=np.float32).tolist()
    return out


class QuantixarService:
    def __init__(self, db: Optional[Database] = None,
                 config: Optional[ServiceConfig] = None, device="cuda"):
        self.db = db if db is not None \
            else Database(device=device)  # guarded-by: _lock
        self.config = config or ServiceConfig()
        # serializes DDL and the restore swap; data-plane ops rely on each
        # collection's own lock
        self._lock = threading.RLock()

    # -------------------------------------------------------------- dispatch
    def dispatch(self, request: rq.Request
                 ) -> Union[rq.Response, rq.ErrorInfo]:
        """Handle one typed request; failures come back as `ErrorInfo`."""
        handler = self._HANDLERS.get(type(request))
        if handler is None:
            return rq.ErrorInfo(
                rq.INVALID_ARGUMENT,
                f"unhandled request type {type(request).__name__}")
        try:
            return handler(self, request)
        except Exception as exc:             # noqa: BLE001 — errors are data
            return to_error_info(exc)

    def dispatch_dict(self, envelope: Dict[str, Any]
                      ) -> Tuple[bool, Dict[str, Any]]:
        """Raw envelope dict -> (ok, result-or-error dict): the full wire
        round-trip for transports that only speak JSON."""
        try:
            request = rq.decode_request(envelope)
        except rq.ApiError as exc:
            return False, exc.info.to_dict()
        out = self.dispatch(request)
        if isinstance(out, rq.ErrorInfo):
            return False, out.to_dict()
        return True, out.to_dict()

    def close(self) -> None:
        with self._lock:
            self.db.close()

    # ------------------------------------------------------------- internals
    def _col(self, name: str):
        try:
            # a restore swaps self.db atomically; data-plane handlers may
            # read the old or new reference, and either is a consistent
            # database whose collections guard themselves
            return self.db.collection(name)  # unguarded-ok: atomic ref snapshot; restore swap is safe to race
        except KeyError as exc:
            raise rq.error_to_exception(
                rq.ErrorInfo(rq.NOT_FOUND, str(exc.args[0])))

    # -------------------------------------------------------------- handlers
    def _create_collection(self, req: rq.CreateCollection) -> rq.CollectionInfo:
        if not isinstance(req.schema, dict):
            raise rq.error_to_exception(rq.ErrorInfo(
                rq.INVALID_ARGUMENT,
                f"schema must be an object, got {type(req.schema).__name__}"))
        schema = CollectionSchema.from_dict(req.schema)
        if schema.batcher is None:           # service-level default knobs
            schema = dataclasses.replace(
                schema, batcher=self.config.default_batcher())
        with self._lock:
            col = self.db.create_collection(schema)
        return rq.CollectionInfo(name=col.name, schema=col.schema.to_dict())

    def _drop_collection(self, req: rq.DropCollection) -> rq.Ack:
        with self._lock:
            try:
                self.db.drop_collection(req.collection)
            except KeyError as exc:
                raise rq.error_to_exception(
                    rq.ErrorInfo(rq.NOT_FOUND, str(exc.args[0])))
        return rq.Ack()

    def _list_collections(self, req: rq.ListCollections) -> rq.CollectionList:
        with self._lock:      # create/drop mutate the dict we iterate
            return rq.CollectionList(collections=self.db.list_collections())

    def _describe_collection(self, req: rq.DescribeCollection
                             ) -> rq.CollectionInfo:
        col = self._col(req.collection)
        return rq.CollectionInfo(name=col.name, schema=col.schema.to_dict())

    def _upsert(self, req: rq.Upsert) -> rq.UpsertResult:
        col = self._col(req.collection)
        vectors = np.asarray(req.vectors, dtype=np.float32)
        n = col.upsert(req.ids, vectors, req.payloads)
        return rq.UpsertResult(upserted=n)

    def _delete(self, req: rq.Delete) -> rq.DeleteResult:
        col = self._col(req.collection)
        return rq.DeleteResult(deleted=col.delete(req.ids))

    def _get(self, req: rq.Get) -> rq.GetResult:
        col = self._col(req.collection)
        e = col.get(req.id)
        if e is None:
            return rq.GetResult(entity=None)
        entity: Dict[str, Any] = {"id": e.id, "payload": e.payload}
        if req.include_vector:
            entity["vector"] = np.asarray(e.vector,
                                          dtype=np.float32).tolist()
        return rq.GetResult(entity=entity)

    def _search(self, req: rq.Search) -> rq.SearchResult:
        col = self._col(req.collection)
        timeout = self.config.query_timeout_s
        if req.plan is not None:
            # full declarative plan: validate/execute through the one plan
            # path (trivial plans still coalesce in the RequestBatcher)
            plan = plan_from_dict(req.plan)
            out = col.execute_plan(plan, include_vector=req.include_vector,
                                   timeout=timeout, explain=req.explain)
            batched = plan.batched
        else:
            if req.vector is None and req.text is None:
                raise rq.error_to_exception(rq.ErrorInfo(
                    rq.INVALID_ARGUMENT,
                    "search needs either 'vector', 'text', or 'plan'"))
            vector = None
            if req.vector is not None:
                vector = np.asarray(req.vector, dtype=np.float32)
            flt = rq.filter_from_dict(req.filter)
            query = col.query(vector).top_k(req.k)
            if req.text is not None:
                # keyword leg: alone -> pure sparse plan; with a vector ->
                # hybrid RRF plan, same compile as the fluent Query.text()
                query = query.text(req.text, field=req.text_field)
            if flt is not None:
                query = query.filter(flt)
            if req.ef is not None:
                query = query.ef(req.ef)
            if req.rescore is not None:
                query = query.rescore(req.rescore)
            if req.expansion_width is not None:
                query = query.expansion_width(req.expansion_width)
            if req.include_vector:
                query = query.include("vector")
            # the fluent builder compiles to a trivial plan: 1-D requests
            # coalesce through the RequestBatcher, 2-D run as one batch
            out = (query.explain(timeout=timeout) if req.explain
                   else query.run(timeout=timeout))
            batched = vector is not None and vector.ndim == 2
        explain = None
        hits = out
        if req.explain:
            hits, explain = out.hits, out.to_dict()
        if not batched:
            return rq.SearchResult(hits=[_hit_to_dict(h) for h in hits],
                                   explain=explain)
        return rq.SearchResult(
            hits=[[_hit_to_dict(h) for h in row] for row in hits],
            batched=True, explain=explain)

    def _count(self, req: rq.Count) -> rq.CountResult:
        col = self._col(req.collection)
        return rq.CountResult(
            count=col.count(rq.filter_from_dict(req.filter)))

    def _compact(self, req: rq.Compact) -> rq.CompactResult:
        col = self._col(req.collection)
        if req.shard is not None:
            if not isinstance(col, ShardedCollection):
                raise ValueError(     # -> INVALID_ARGUMENT
                    f"collection {req.collection!r} is not sharded; "
                    f"omit 'shard'")
            return rq.CompactResult(reclaimed=col.compact(shard=req.shard))
        return rq.CompactResult(reclaimed=col.compact())

    def _rebalance(self, req: rq.Rebalance) -> rq.RebalanceResult:
        col = self._col(req.collection)
        if not isinstance(col, ShardedCollection):
            raise ValueError(         # -> INVALID_ARGUMENT
                f"collection {req.collection!r} is not sharded; create it "
                f"with shards > 1 or replicas > 1 to rebalance")
        info = col.rebalance(shards=req.shards, replicas=req.replicas)
        return rq.RebalanceResult(shards=info["shards"],
                                  replicas=info["replicas"],
                                  rows=info["rows"],
                                  seconds=info["seconds"])

    def _shard_stats(self, req: rq.ShardStats) -> rq.ShardStatsResult:
        # uniform: a plain collection answers as one shard of one replica
        return rq.ShardStatsResult(
            shards=self._col(req.collection).shard_stats())

    def _stats(self, req: rq.Stats) -> rq.StatsResult:
        if req.collection is not None:
            return rq.StatsResult(stats=self._col(req.collection).stats())
        with self._lock:      # whole-db stats iterate the collections dict
            return rq.StatsResult(stats=self.db.stats())

    def _snapshot(self, req: rq.Snapshot) -> rq.SnapshotResult:
        with self._lock:
            gen = self.db.save(req.path, step=req.step)
        return rq.SnapshotResult(generation=gen)

    def _restore(self, req: rq.Restore) -> rq.RestoreResult:
        loaded = Database.load(req.path, generation=req.generation,
                               device=self.db.device)
        with self._lock:
            old, self.db = self.db, loaded
        old.close()
        return rq.RestoreResult(collections=loaded.list_collections())

    def _health(self, req: rq.Health) -> rq.HealthResult:
        return rq.HealthResult()

    _HANDLERS: Dict[Type[rq.Request], Callable] = {
        rq.CreateCollection: _create_collection,
        rq.DropCollection: _drop_collection,
        rq.ListCollections: _list_collections,
        rq.DescribeCollection: _describe_collection,
        rq.Upsert: _upsert,
        rq.Delete: _delete,
        rq.Get: _get,
        rq.Search: _search,
        rq.Count: _count,
        rq.Compact: _compact,
        rq.Rebalance: _rebalance,
        rq.ShardStats: _shard_stats,
        rq.Stats: _stats,
        rq.Snapshot: _snapshot,
        rq.Restore: _restore,
        rq.Health: _health,
    }
