"""Versioned wire protocol for the Quantixar request plane.

Every operation a client can perform — collection DDL, point CRUD, filtered
search, compaction, stats, snapshot/restore — is a dataclass here with a
plain-dict JSON codec, so any transport (the stdlib HTTP server in
`serving.http`, a test harness calling `QuantixarService` directly)
speaks the same typed language.  Failures travel the same way: a structured
`ErrorInfo` (code + message + details) instead of a traceback, with a fixed
taxonomy every transport maps onto its own status space.

The protocol is versioned (`PROTOCOL_VERSION`); request envelopes carry the
version and an `op` tag, and `decode_request` rejects unknown versions/ops
with `INVALID_ARGUMENT` rather than guessing.

Carried across from the JAX package's ``repro.api.requests`` unchanged but
for its imports: the port's requests and responses serialize to the same
dicts, so the port's client and server speak to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Type, Union

from ..core.metadata import And, Filter, Not, Or, Predicate
from .schema import SchemaError

PROTOCOL_VERSION = 1

# ------------------------------------------------------------ error taxonomy
SCHEMA_ERROR = "SCHEMA_ERROR"          # request violates a collection schema
NOT_FOUND = "NOT_FOUND"                # unknown collection / id / route
INVALID_ARGUMENT = "INVALID_ARGUMENT"  # malformed request (bad JSON, op, ...)
UNAVAILABLE = "UNAVAILABLE"            # transient: shutting down, timeout
INTERNAL = "INTERNAL"                  # unexpected server-side failure

ERROR_CODES = (SCHEMA_ERROR, NOT_FOUND, INVALID_ARGUMENT, UNAVAILABLE,
               INTERNAL)


@dataclasses.dataclass
class ErrorInfo:
    """A failure as data: taxonomy code, human message, optional details."""

    code: str
    message: str
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.code not in ERROR_CODES:
            self.code = INTERNAL

    def to_dict(self) -> Dict[str, Any]:
        out = {"code": self.code, "message": self.message}
        if self.details:
            out["details"] = self.details
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ErrorInfo":
        return cls(code=str(d.get("code", INTERNAL)),
                   message=str(d.get("message", "")),
                   details=dict(d.get("details") or {}))


class ApiError(Exception):
    """Carrier for an `ErrorInfo` across the client/service boundary."""

    def __init__(self, info: ErrorInfo) -> None:
        super().__init__(f"[{info.code}] {info.message}")
        self.info = info

    # without this, RemoteNotFound would pick up KeyError.__str__ and
    # render its message repr-quoted
    __str__ = Exception.__str__

    @property
    def code(self) -> str:
        return self.info.code


# Client-side mirrors that keep exception parity with the embedded API:
# a remote SCHEMA_ERROR is catchable as `SchemaError`, a remote NOT_FOUND
# as `KeyError`, so the same test scenarios run embedded or over the wire.
class RemoteSchemaError(ApiError, SchemaError):
    pass


class RemoteNotFound(ApiError, KeyError):
    pass


class RemoteInvalidArgument(ApiError, ValueError):
    pass


class RemoteUnavailable(ApiError):
    pass


_ERROR_EXCEPTIONS: Dict[str, Type[ApiError]] = {
    SCHEMA_ERROR: RemoteSchemaError,
    NOT_FOUND: RemoteNotFound,
    INVALID_ARGUMENT: RemoteInvalidArgument,
    UNAVAILABLE: RemoteUnavailable,
    INTERNAL: ApiError,
}


def error_to_exception(info: ErrorInfo) -> ApiError:
    """The `ApiError` subclass whose extra bases match the embedded API's
    exception for this failure class."""
    return _ERROR_EXCEPTIONS.get(info.code, ApiError)(info)


# ------------------------------------------------------------- filter codec
def filter_to_dict(flt: Optional[Filter]) -> Optional[Dict[str, Any]]:
    """Serialize a full filter tree (Predicate/And/Or/Not) to plain JSON."""
    if flt is None:
        return None
    if isinstance(flt, Predicate):
        value = list(flt.value) if isinstance(flt.value, (tuple, list, set)) \
            else flt.value
        return {"pred": {"column": flt.column, "op": flt.op, "value": value}}
    if isinstance(flt, And):
        return {"and": [filter_to_dict(c) for c in flt.clauses]}
    if isinstance(flt, Or):
        return {"or": [filter_to_dict(c) for c in flt.clauses]}
    if isinstance(flt, Not):
        return {"not": filter_to_dict(flt.clause)}
    raise SchemaError(f"not a filter: {flt!r}")


def filter_from_dict(d: Optional[Dict[str, Any]]) -> Optional[Filter]:
    if d is None:
        return None
    if not isinstance(d, dict) or len(d) != 1:
        raise SchemaError(f"malformed filter node: {d!r}")
    kind, body = next(iter(d.items()))
    if kind == "pred":
        value = body["value"]
        if isinstance(value, list):          # JSON lists -> hashable tuples
            value = tuple(value)
        return Predicate(body["column"], body["op"], value)
    if kind == "and":
        return And(tuple(filter_from_dict(c) for c in body))
    if kind == "or":
        return Or(tuple(filter_from_dict(c) for c in body))
    if kind == "not":
        return Not(filter_from_dict(body))
    raise SchemaError(f"unknown filter node kind {kind!r}")


# ----------------------------------------------------------------- requests
_REQUEST_TYPES: Dict[str, Type["Request"]] = {}


@dataclasses.dataclass
class Request:
    """Base request: `op` identifies the operation on the wire."""

    op = "abstract"

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        if cls.op != "abstract":
            _REQUEST_TYPES[cls.op] = cls

    def to_dict(self) -> Dict[str, Any]:
        return {"v": PROTOCOL_VERSION, "op": self.op,
                "body": dataclasses.asdict(self)}


@dataclasses.dataclass
class CreateCollection(Request):
    """DDL: create a collection from a `CollectionSchema.to_dict()` payload."""

    schema: Dict[str, Any]
    op = "create_collection"


@dataclasses.dataclass
class DropCollection(Request):
    collection: str
    op = "drop_collection"


@dataclasses.dataclass
class ListCollections(Request):
    op = "list_collections"


@dataclasses.dataclass
class DescribeCollection(Request):
    collection: str
    op = "describe_collection"


@dataclasses.dataclass
class Upsert(Request):
    collection: str
    ids: List[str]
    vectors: List[List[float]]
    payloads: Optional[List[Optional[Dict[str, Any]]]] = None
    op = "upsert"


@dataclasses.dataclass
class Delete(Request):
    collection: str
    ids: List[str]
    op = "delete"


@dataclasses.dataclass
class Get(Request):
    collection: str
    id: str
    include_vector: bool = True
    op = "get"


@dataclasses.dataclass
class Search(Request):
    """Single (1-D `vector`) or batch (2-D `vector`) filtered search.

    Two forms:

      * legacy fields — `vector`/`k`/`filter` plus the per-request knobs
        (`ef`/`rescore`/`expansion_width`), which the server compiles to a
        trivial single-stage plan.  `text` (optionally `text_field`)
        instead of / alongside `vector` asks for BM25 keyword search —
        alone it compiles to a sparse plan, with a vector to a hybrid
        RRF-fused plan, exactly like the fluent `Query.text()`;
      * `plan` — a full `plan_to_dict` tree (coarse-to-fine stages,
        prefetch sub-plans incl. sparse legs, fusion), the wire form of
        the fluent `Query`.  When `plan` is set it is the whole query; the
        legacy fields are ignored and the root vector rides inside the
        plan.

    `explain=True` asks the server to echo the compiled plan and per-stage
    candidate counts/timings alongside the hits.
    """

    collection: str
    vector: Optional[List[Any]] = None
    k: int = 10
    filter: Optional[Dict[str, Any]] = None
    ef: Optional[int] = None
    rescore: Optional[bool] = None
    expansion_width: Optional[int] = None
    include_vector: bool = False
    plan: Optional[Dict[str, Any]] = None
    explain: bool = False
    text: Optional[str] = None
    text_field: Optional[str] = None
    op = "search"

    @property
    def batched(self) -> bool:
        """Legacy-form (vector-field) batched-ness; plan-form requests get
        it from the parsed `QueryPlan.batched` instead."""
        return bool(self.vector) and isinstance(self.vector[0], (list, tuple))


@dataclasses.dataclass
class Count(Request):
    """Filtered cardinality: how many live entities match `filter`
    (all of them when None) — no hits fetched, no vector work."""

    collection: str
    filter: Optional[Dict[str, Any]] = None
    op = "count"


@dataclasses.dataclass
class Compact(Request):
    """`shard` (sharded collections only) compacts one shard instead of
    the whole collection."""

    collection: str
    shard: Optional[int] = None
    op = "compact"


@dataclasses.dataclass
class Rebalance(Request):
    """Re-partition a sharded collection onto `shards` shards x `replicas`
    replicas (None = keep current) via snapshot + re-upsert."""

    collection: str
    shards: Optional[int] = None
    replicas: Optional[int] = None
    op = "rebalance"


@dataclasses.dataclass
class ShardStats(Request):
    """Per-shard breakdown: rows/tombstones/queue depth, owned hash slots,
    replica health.  A plain collection answers as one shard."""

    collection: str
    op = "shard_stats"


@dataclasses.dataclass
class Stats(Request):
    collection: Optional[str] = None      # None: whole-database stats
    op = "stats"


@dataclasses.dataclass
class Snapshot(Request):
    """Persist every collection as one atomic checkpoint generation."""

    path: str
    step: int = 0
    op = "snapshot"


@dataclasses.dataclass
class Restore(Request):
    """Replace the served database with a snapshot generation."""

    path: str
    generation: Optional[int] = None
    op = "restore"


@dataclasses.dataclass
class Health(Request):
    op = "health"


AnyRequest = Union[CreateCollection, DropCollection, ListCollections,
                   DescribeCollection, Upsert, Delete, Get, Search, Count,
                   Compact, Rebalance, ShardStats, Stats, Snapshot, Restore,
                   Health]


def decode_request(d: Dict[str, Any]) -> Request:
    """Envelope dict -> typed request; malformed input raises `ApiError`
    with `INVALID_ARGUMENT` (never a bare KeyError/TypeError)."""
    if not isinstance(d, dict):
        raise error_to_exception(ErrorInfo(
            INVALID_ARGUMENT, f"request must be an object, got "
            f"{type(d).__name__}"))
    version = d.get("v", PROTOCOL_VERSION)
    if version != PROTOCOL_VERSION:
        raise error_to_exception(ErrorInfo(
            INVALID_ARGUMENT, f"unsupported protocol version {version!r}; "
            f"this server speaks v{PROTOCOL_VERSION}"))
    op = d.get("op")
    cls = _REQUEST_TYPES.get(op)
    if cls is None:
        raise error_to_exception(ErrorInfo(
            INVALID_ARGUMENT, f"unknown op {op!r}",
            {"known_ops": sorted(_REQUEST_TYPES)}))
    body = d.get("body") or {}
    try:
        return cls(**body)
    except TypeError as exc:
        raise error_to_exception(ErrorInfo(
            INVALID_ARGUMENT, f"bad body for op {op!r}: {exc}"))


# ---------------------------------------------------------------- responses
@dataclasses.dataclass
class Response:
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Response":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class Ack(Response):
    ok: bool = True


@dataclasses.dataclass
class CollectionInfo(Response):
    name: str
    schema: Dict[str, Any]


@dataclasses.dataclass
class CollectionList(Response):
    collections: List[str]


@dataclasses.dataclass
class UpsertResult(Response):
    upserted: int


@dataclasses.dataclass
class DeleteResult(Response):
    deleted: int


@dataclasses.dataclass
class GetResult(Response):
    entity: Optional[Dict[str, Any]]      # {id, payload, vector?} or None


@dataclasses.dataclass
class SearchResult(Response):
    """`hits` is a list of hit dicts for single queries, a list of lists for
    batch queries (`batched` disambiguates the empty case).  When the
    request asked for `explain`, `explain` carries the compiled plan echo
    plus the executor's per-stage report."""

    hits: List[Any]
    batched: bool = False
    explain: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class CountResult(Response):
    count: int = 0


@dataclasses.dataclass
class CompactResult(Response):
    reclaimed: int


@dataclasses.dataclass
class RebalanceResult(Response):
    shards: int
    replicas: int
    rows: int
    seconds: float


@dataclasses.dataclass
class ShardStatsResult(Response):
    shards: List[Dict[str, Any]]


@dataclasses.dataclass
class StatsResult(Response):
    stats: Dict[str, Any]


@dataclasses.dataclass
class SnapshotResult(Response):
    generation: int


@dataclasses.dataclass
class RestoreResult(Response):
    collections: List[str]


@dataclasses.dataclass
class HealthResult(Response):
    status: str = "ok"
    version: int = PROTOCOL_VERSION
