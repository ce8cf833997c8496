"""`QuantixarClient`: the wire-protocol client mirroring `Database`.

The client's surface is deliberately isomorphic to the embedded API —
`create_collection` / `collection` / `drop_collection` / `list_collections`
on the client, `upsert` / `get` / `delete` / `query` / `compact` / `stats`
on `RemoteCollection` — so the same test scenarios run against either.
`RemoteCollection.query()` even reuses the embedded fluent `Query` builder:
validation (dims, filter ops, top_k, plan structure) happens client-side
against the cached schema, and only `execute_plan` differs — the compiled
`QueryPlan` ships as a `Search` request over HTTP instead of running
against a local engine, so multi-stage/fused/explain queries behave
identically on both sides.

Server failures arrive as structured `ErrorInfo` and are raised as
`ApiError` subclasses that keep exception parity with the embedded layer
(`RemoteSchemaError` is a `SchemaError`, `RemoteNotFound` a `KeyError`).
Stdlib-only: one keep-alive `http.client.HTTPConnection` per calling thread
(the server speaks HTTP/1.1), so benchmarks measure the request plane, not
per-request TCP setup.

Carried across from the JAX package's ``repro.api.client`` unchanged but
for its imports, which resolve in this package: the client holds no engine
and no device, and its requests are the reference's byte for byte, so it
speaks to either package's server.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import socket
import threading
from typing import Any, Dict, List, Optional, Sequence, Union
from urllib.parse import quote, urlsplit

import numpy as np

from ..core.metadata import Filter
from . import requests as rq
from .collection import Entity
from .plan import (PlanExplain, QueryPlan, plan_to_dict, recommend_vector,
                   validate_filter, validate_plan)
from .query import Hit, Query
from .schema import (BatcherConfig, CollectionSchema, MetadataField,
                     SchemaError, VectorField)


def _hit_from_dict(d: Dict[str, Any]) -> Hit:
    vector = d.get("vector")
    return Hit(id=d["id"], score=float(d["score"]),
               payload=d.get("payload") or {},
               vector=(np.asarray(vector, dtype=np.float32)
                       if vector is not None else None))


class QuantixarClient:
    """Thin HTTP client for a Quantixar server (`repro_torch.serving.http`).

    `timeout` caps every request; `Query.run(timeout=...)` can tighten —
    never widen — it for one search (effective deadline is the minimum of
    the two).
    """

    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        parts = urlsplit(self.base_url if "://" in self.base_url
                         else f"http://{self.base_url}")
        if parts.scheme != "http" or parts.hostname is None:
            raise ValueError(f"expected an http://host:port URL, "
                             f"got {base_url!r}")
        self._host = parts.hostname
        self._port = parts.port or 80
        self._base_path = parts.path.rstrip("/")
        self._local = threading.local()      # one keep-alive conn per thread

    # ------------------------------------------------------------- transport
    def _conn(self, timeout: float) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=timeout)
            self._local.conn = conn
        else:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
        self._local.conn = None

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None,
              timeout: Optional[float] = None) -> Dict[str, Any]:
        effective = (self.timeout if timeout is None
                     else min(timeout, self.timeout))
        data = None if body is None else json.dumps(body).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        # one retry on a fresh connection covers the stale-keep-alive case
        # (e.g. server restarted); our server never closes a connection
        # after accepting a request without sending its response, so the
        # retry cannot double-apply a write
        for attempt in (0, 1):
            conn = self._conn(effective)
            try:
                conn.request(method, self._base_path + path, body=data,
                             headers=headers)
                resp = conn.getresponse()
                status, raw = resp.status, resp.read()
                break
            except socket.timeout:
                self._drop_conn()
                raise rq.error_to_exception(rq.ErrorInfo(
                    rq.UNAVAILABLE,
                    f"request timed out after {effective}s"))
            except (ConnectionError, http.client.HTTPException,
                    OSError) as exc:
                self._drop_conn()
                if attempt:
                    raise rq.error_to_exception(rq.ErrorInfo(
                        rq.UNAVAILABLE, f"server unreachable: {exc}"))
        try:
            envelope = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise rq.error_to_exception(rq.ErrorInfo(
                rq.INTERNAL, f"HTTP {status}: non-JSON response body"))
        if not envelope.get("ok", False):
            raise rq.error_to_exception(
                rq.ErrorInfo.from_dict(envelope.get("error") or {}))
        return envelope.get("result") or {}

    # ------------------------------------------------------------ management
    def health(self) -> Dict[str, Any]:
        return self._call("GET", "/v1/healthz")

    def create_collection(
            self,
            schema: Optional[CollectionSchema] = None, *,
            name: Optional[str] = None,
            vector: Optional[VectorField] = None,
            fields: Sequence[MetadataField] = (),
            batcher: Optional[BatcherConfig] = None,
            shards: int = 1,
            replicas: int = 1) -> "RemoteCollection":
        if schema is None:
            if name is None or vector is None:
                raise SchemaError(
                    "pass a CollectionSchema or name= and vector=")
            schema = CollectionSchema(
                name=name, vector=vector, fields=tuple(fields),
                batcher=batcher, shards=shards, replicas=replicas)
        else:                          # parity with Database.create_collection
            if batcher is not None:
                schema = dataclasses.replace(schema, batcher=batcher)
            if shards != 1 or replicas != 1:
                schema = dataclasses.replace(schema, shards=shards,
                                             replicas=replicas)
        result = self._call("POST", "/v1/collections",
                            {"schema": schema.to_dict()})
        return RemoteCollection(
            self, CollectionSchema.from_dict(result["schema"]))

    def collection(self, name: str) -> "RemoteCollection":
        result = self._call("GET", f"/v1/collections/{quote(name, safe='')}")
        return RemoteCollection(
            self, CollectionSchema.from_dict(result["schema"]))

    __getitem__ = collection

    def __contains__(self, name: str) -> bool:
        return name in self.list_collections()

    def list_collections(self) -> List[str]:
        return list(self._call("GET", "/v1/collections")["collections"])

    def drop_collection(self, name: str) -> None:
        self._call("DELETE", f"/v1/collections/{quote(name, safe='')}")

    # ----------------------------------------------------------- persistence
    def snapshot(self, path: str, *, step: int = 0) -> int:
        """Server-side `Database.save` of every collection; returns the
        checkpoint generation id."""
        return int(self._call("POST", "/v1/snapshot",
                              {"path": path, "step": step})["generation"])

    def restore(self, path: str, *,
                generation: Optional[int] = None) -> List[str]:
        """Swap the served database for a snapshot generation; returns the
        restored collection names."""
        body: Dict[str, Any] = {"path": path}
        if generation is not None:
            body["generation"] = generation
        return list(self._call("POST", "/v1/restore", body)["collections"])

    def stats(self) -> Dict[str, Any]:
        return self._call("GET", "/v1/stats")["stats"]

    def close(self) -> None:
        """Close this thread's keep-alive connection (other threads'
        connections close with their threads)."""
        self._drop_conn()


class RemoteCollection:
    """Client-side handle mirroring `Collection`'s data-plane surface."""

    def __init__(self, client: QuantixarClient, schema: CollectionSchema):
        self._client = client
        self.schema = schema

    @property
    def name(self) -> str:
        return self.schema.name

    def _path(self, suffix: str = "") -> str:
        return f"/v1/collections/{quote(self.name, safe='')}{suffix}"

    # ---------------------------------------------------------------- writes
    def upsert(self, ids: Union[str, Sequence[str]],
               vectors: np.ndarray,
               payloads: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
               ) -> int:
        ids = [ids] if isinstance(ids, str) else list(ids)
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        body: Dict[str, Any] = {"ids": ids, "vectors": vectors.tolist()}
        if payloads is not None:
            body["payloads"] = list(payloads)
        result = self._client._call("POST", self._path("/points"), body)
        return int(result["upserted"])

    def delete(self, ids: Union[str, Sequence[str]]) -> int:
        ids = [ids] if isinstance(ids, str) else list(ids)
        result = self._client._call("POST", self._path("/points/delete"),
                                    {"ids": ids})
        return int(result["deleted"])

    def compact(self, shard: Optional[int] = None) -> int:
        body: Dict[str, Any] = {} if shard is None else {"shard": shard}
        result = self._client._call("POST", self._path("/compact"), body)
        return int(result["reclaimed"])

    def rebalance(self, shards: Optional[int] = None,
                  replicas: Optional[int] = None) -> Dict[str, Any]:
        """Re-shard / re-replicate a sharded collection server-side
        (snapshot-based move; see `ShardedCollection.rebalance`)."""
        body: Dict[str, Any] = {}
        if shards is not None:
            body["shards"] = shards
        if replicas is not None:
            body["replicas"] = replicas
        return dict(self._client._call("POST", self._path("/rebalance"),
                                       body))

    def shard_stats(self) -> List[Dict[str, Any]]:
        """Per-shard rows/tombstones/queue-depth (single-shard collections
        report one pseudo-shard)."""
        return list(self._client._call("GET",
                                       self._path("/shards"))["shards"])

    # ----------------------------------------------------------------- reads
    def get(self, id: str) -> Optional[Entity]:
        entity = self._client._call(
            "GET", self._path(f"/points/{quote(id, safe='')}"))["entity"]
        if entity is None:
            return None
        return Entity(
            id=entity["id"],
            vector=np.asarray(entity.get("vector", ()), dtype=np.float32),
            payload=entity.get("payload") or {})

    def query(self, vector: Optional[np.ndarray] = None) -> Query:
        """The embedded fluent builder, executed over the wire.  Vectorless
        queries (`.query().text("...")`) compile to sparse keyword plans."""
        return Query(self, vector)

    def recommend(self, positives: Sequence[Any],
                  negatives: Sequence[Any] = ()) -> Query:
        """Fluent query from example entities (ids resolved over the wire,
        raw vectors used as-is): mean(positives) - mean(negatives)."""
        return Query(self, recommend_vector(self, positives, negatives))

    def count(self, flt: Optional[Filter] = None) -> int:
        """Filtered cardinality without fetching hits (wire `Count` op)."""
        body: Dict[str, Any] = {}
        if flt is not None:
            flt = validate_filter(self.schema, flt)
            body["filter"] = rq.filter_to_dict(flt)
        return int(self._client._call("POST", self._path("/count"),
                                      body)["count"])

    def stats(self) -> Dict[str, Any]:
        return self._client._call("GET", self._path("/stats"))["stats"]

    def __len__(self) -> int:
        return int(self.stats()["live"])

    def __contains__(self, id: str) -> bool:
        return self.get(id) is not None

    def close(self) -> None:
        """Parity no-op: server owns the collection's resources."""

    # ------------------------------------------------------------- internals
    def execute_plan(self, plan: QueryPlan, *, include_vector: bool = False,
                     timeout: float = 120.0, explain: bool = False):
        """`Query.run`/`Query.explain` backend: ship the compiled plan as
        one `Search` request (the wire twin of `Collection.execute_plan`)."""
        # client-side validation keeps error parity with the embedded API
        # (bad dims / unknown fields fail before any bytes hit the wire)
        plan = validate_plan(self.schema, plan)
        body: Dict[str, Any] = {"plan": plan_to_dict(plan)}
        if include_vector:
            body["include_vector"] = True
        if explain:
            body["explain"] = True
        # honor Query.run(timeout=...) like the embedded Future.result does
        result = self._client._call("POST", self._path("/search"), body,
                                    timeout=timeout)
        raw = result["hits"]
        if plan.batched:
            hits = [[_hit_from_dict(h) for h in row] for row in raw]
        else:
            hits = [_hit_from_dict(h) for h in raw]
        if explain:
            echo = result.get("explain") or {}
            return PlanExplain(plan=echo.get("plan") or {},
                               stages=list(echo.get("stages") or ()),
                               hits=hits)
        return hits
