"""Declarative collection schemas for the public API layer.

A `CollectionSchema` is the single source of truth for a collection: one
vector field (dim / metric / index / quantization and their tuning knobs)
plus typed metadata fields (keyword / numeric / bool) that are validated at
upsert time.  The schema compiles down to the engine's `EngineConfig` and
round-trips through plain dicts so `Database.save()` can persist it inside
the checkpoint manifest.

Carried across from the JAX package's ``repro.api.schema`` unchanged but
for its imports, which resolve in this package: the engine config, the
HNSW / PQ / BQ / IVF configs, the metric registry (which holds the same
names as the JAX one, ``hamming`` included) and the tokenizer config are
the port's own, so both packages accept the same schemas and serialize
them to the same dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..core.bq import BQConfig
from ..core.distances import available_metrics
from ..core.engine import EngineConfig
from ..core.hnsw_build import HNSWConfig
from ..core.ivf import IVFConfig
from ..core.pq import PQConfig
from ..core.sparse import TokenizerConfig

INDEXES = ("hnsw", "flat", "ivf")
QUANTIZATIONS = ("none", "pq", "bq")
BUILDERS = ("incremental", "bulk", "bulk_ref")

# column names the Collection layer reserves for itself
RESERVED_NAMES = ("id", "score", "vector")


class SchemaError(ValueError):
    """Invalid schema definition or payload that violates the schema."""


# --------------------------------------------------------------------- fields
@dataclasses.dataclass(frozen=True)
class MetadataField:
    """Base typed metadata field; subclasses define `kind` + type checking."""

    name: str
    required: bool = False
    kind = "abstract"

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise SchemaError(f"field name must be a non-empty str, "
                              f"got {self.name!r}")
        if self.name in RESERVED_NAMES:
            raise SchemaError(f"field name {self.name!r} is reserved")

    def validate(self, value: Any) -> Any:
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "required": self.required}


@dataclasses.dataclass(frozen=True)
class KeywordField(MetadataField):
    """Exact-match string attribute (eq/ne/in filters)."""

    kind = "keyword"

    def validate(self, value: Any) -> str:
        if not isinstance(value, str):
            raise SchemaError(
                f"field {self.name!r} expects str, got {type(value).__name__}")
        return value


@dataclasses.dataclass(frozen=True)
class NumericField(MetadataField):
    """int/float attribute (full comparison-operator set)."""

    kind = "numeric"

    def validate(self, value: Any) -> float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaError(
                f"field {self.name!r} expects a number, "
                f"got {type(value).__name__}")
        return float(value)


@dataclasses.dataclass(frozen=True)
class BoolField(MetadataField):
    """Boolean attribute (eq/ne filters)."""

    kind = "bool"

    def validate(self, value: Any) -> bool:
        if not isinstance(value, bool):
            raise SchemaError(
                f"field {self.name!r} expects bool, "
                f"got {type(value).__name__}")
        return value


@dataclasses.dataclass(frozen=True)
class TextField(MetadataField):
    """Full-text attribute: tokenized at upsert time into the collection's
    BM25 `SparseIndex`, queried via `Query.text(...)` / `SparseStage`.

    The tokenization rules are part of the schema (serialized and
    round-tripped through the checkpoint manifest) so documents and
    queries always tokenize identically.  `stopwords=None` selects the
    default English list; an empty tuple disables stopword removal.
    Text fields are retrieval-only: they accept no filter predicates.
    """

    lowercase: bool = True
    min_token_len: int = 2
    stopwords: Optional[Tuple[str, ...]] = None
    kind = "text"

    def __post_init__(self) -> None:
        super().__post_init__()
        if not isinstance(self.min_token_len, int) or self.min_token_len < 1:
            raise SchemaError(f"field {self.name!r}: min_token_len must be "
                              f"a positive int, got {self.min_token_len!r}")
        if self.stopwords is not None:
            words = tuple(self.stopwords)
            if not all(isinstance(w, str) for w in words):
                raise SchemaError(
                    f"field {self.name!r}: stopwords must be strings")
            object.__setattr__(self, "stopwords", words)

    def validate(self, value: Any) -> str:
        if not isinstance(value, str):
            raise SchemaError(
                f"field {self.name!r} expects str, got {type(value).__name__}")
        return value

    def tokenizer(self) -> TokenizerConfig:
        return TokenizerConfig(lowercase=self.lowercase,
                               min_token_len=self.min_token_len,
                               stopwords=self.stopwords)

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        out.update({"lowercase": self.lowercase,
                    "min_token_len": self.min_token_len,
                    "stopwords": (list(self.stopwords)
                                  if self.stopwords is not None else None)})
        return out


_FIELD_KINDS = {"keyword": KeywordField, "numeric": NumericField,
                "bool": BoolField, "text": TextField}

# ops a filter may apply per field kind ("text" is retrieval-only: it has
# no predicate ops, so filters on it fail fast with a clear message)
FIELD_OPS = {
    "keyword": ("eq", "ne", "in"),
    "numeric": ("eq", "ne", "lt", "le", "gt", "ge", "in"),
    "bool": ("eq", "ne"),
    "text": (),
}


def field_from_dict(d: Dict[str, Any]) -> MetadataField:
    kind = d.get("kind")
    if kind not in _FIELD_KINDS:
        raise SchemaError(f"unknown field kind {kind!r}")
    kw = {k: v for k, v in d.items() if k != "kind"}
    if kind == "text" and kw.get("stopwords") is not None:
        kw["stopwords"] = tuple(kw["stopwords"])
    kw["required"] = bool(kw.get("required", False))
    try:
        return _FIELD_KINDS[kind](**kw)
    except TypeError as exc:
        raise SchemaError(f"bad {kind!r} field definition: {exc}")


# --------------------------------------------------------------- vector field
@dataclasses.dataclass(frozen=True)
class VectorField:
    """The collection's single vector attribute + index/quantization choice."""

    dim: int
    metric: str = "cosine"
    index: str = "hnsw"
    quantization: str = "none"
    hnsw: HNSWConfig = dataclasses.field(default_factory=HNSWConfig)
    pq: PQConfig = dataclasses.field(default_factory=PQConfig)
    bq: BQConfig = dataclasses.field(default_factory=BQConfig)
    ivf: IVFConfig = dataclasses.field(default_factory=IVFConfig)
    ef_search: int = 64
    rescore: bool = True
    rescore_multiplier: int = 4
    # API default: the device-parallel bulk HNSW constructor; "incremental"
    # is the paper-faithful serial builder, "bulk_ref" the numpy reference
    builder: str = "bulk"

    def __post_init__(self) -> None:
        if not isinstance(self.dim, int) or self.dim <= 0:
            raise SchemaError(f"dim must be a positive int, got {self.dim!r}")
        if self.builder not in BUILDERS:
            raise SchemaError(f"builder {self.builder!r}; have {BUILDERS}")
        if self.metric not in available_metrics():
            raise SchemaError(f"metric {self.metric!r}; "
                              f"have {sorted(available_metrics())}")
        if self.index not in INDEXES:
            raise SchemaError(f"index {self.index!r}; have {INDEXES}")
        if self.quantization not in QUANTIZATIONS:
            raise SchemaError(f"quantization {self.quantization!r}; "
                              f"have {QUANTIZATIONS}")
        if self.quantization == "pq" and self.dim % self.pq.m != 0:
            raise SchemaError(
                f"dim={self.dim} not divisible by pq.m={self.pq.m}")

    def to_engine_config(self) -> EngineConfig:
        return EngineConfig(
            dim=self.dim, metric=self.metric, index=self.index,
            quantization=self.quantization, pq=self.pq, bq=self.bq,
            hnsw=self.hnsw, ivf=self.ivf, builder=self.builder,
            ef_search=self.ef_search, rescore=self.rescore,
            rescore_multiplier=self.rescore_multiplier)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VectorField":
        d = dict(d)
        for key, sub in (("hnsw", HNSWConfig), ("pq", PQConfig),
                         ("bq", BQConfig), ("ivf", IVFConfig)):
            if isinstance(d.get(key), dict):
                d[key] = sub(**d[key])
        return cls(**d)


# ------------------------------------------------------------ batcher config
@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Serving-batcher knobs for a collection's single-vector query path.

    `max_batch` caps how many coalesced queries form one padded engine batch;
    `max_wait_ms` bounds how long the first request waits for company (the
    tail-latency cap at low QPS).  Declared on the schema so the service
    plane can tune them per collection instead of the old hardcoded values.
    """

    max_batch: int = 32
    max_wait_ms: float = 2.0

    def __post_init__(self) -> None:
        if not isinstance(self.max_batch, int) or self.max_batch < 1:
            raise SchemaError(
                f"batcher max_batch must be a positive int, "
                f"got {self.max_batch!r}")
        if not isinstance(self.max_wait_ms, (int, float)) \
                or self.max_wait_ms < 0:
            raise SchemaError(
                f"batcher max_wait_ms must be >= 0, got {self.max_wait_ms!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"max_batch": self.max_batch,
                "max_wait_ms": float(self.max_wait_ms)}


# --------------------------------------------------------------------- schema
@dataclasses.dataclass(frozen=True)
class CollectionSchema:
    """Named collection layout: one vector field + typed metadata fields."""

    name: str
    vector: VectorField
    fields: Tuple[MetadataField, ...] = ()
    # None = unspecified: the collection falls back to BatcherConfig()
    # defaults, and the service plane may substitute its own defaults —
    # an explicit BatcherConfig always wins over both
    batcher: Optional[BatcherConfig] = None
    # horizontal layout: rows hash-partition across `shards` engine shards,
    # each mirrored `replicas` times for read fan-out.  1/1 = the plain
    # single-engine Collection; anything else materializes a
    # `repro_torch.cluster.ShardedCollection` behind the same API
    shards: int = 1
    replicas: int = 1

    # shards is bounded by the router's hash-slot count (rebalance moves
    # whole slots, so more shards than slots would leave some empty)
    MAX_SHARDS = 64
    MAX_REPLICAS = 8

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise SchemaError("collection name must be a non-empty str")
        if "/" in self.name:
            raise SchemaError("collection name must not contain '/' "
                              "(used as a checkpoint key separator)")
        for attr, cap in (("shards", self.MAX_SHARDS),
                          ("replicas", self.MAX_REPLICAS)):
            value = getattr(self, attr)
            if isinstance(value, bool) or not isinstance(value, int) \
                    or not 1 <= value <= cap:
                raise SchemaError(
                    f"{attr} must be an int in [1, {cap}], got {value!r}")
        object.__setattr__(self, "fields", tuple(self.fields))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise SchemaError(f"duplicate field names in {names}")

    def field(self, name: str) -> MetadataField:
        for f in self.fields:
            if f.name == name:
                return f
        raise SchemaError(f"collection {self.name!r} has no field {name!r}; "
                          f"have {[f.name for f in self.fields]}")

    def field_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def text_fields(self) -> Tuple["TextField", ...]:
        return tuple(f for f in self.fields if f.kind == "text")

    def resolve_text_field(self, name: Optional[str]) -> "TextField":
        """The text field a sparse query targets; `None` picks the
        collection's single text field (ambiguity is an error)."""
        text = self.text_fields()
        if name is None:
            if len(text) == 1:
                return text[0]
            if not text:
                raise SchemaError(
                    f"collection {self.name!r} has no text fields; add a "
                    f"TextField to the schema to use sparse/text search")
            raise SchemaError(
                f"collection {self.name!r} has {len(text)} text fields "
                f"({[f.name for f in text]}); specify field=")
        fld = self.field(name)          # raises on unknown column
        if fld.kind != "text":
            raise SchemaError(f"field {name!r} is {fld.kind!r}, not a "
                              f"text field")
        return fld

    def validate_payload(self,
                         payload: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """Type-check a payload against the schema; returns the normalized
        payload (numerics coerced to float).  Unknown keys are rejected."""
        payload = payload or {}
        if not isinstance(payload, dict):
            raise SchemaError(f"payload must be a dict, "
                              f"got {type(payload).__name__}")
        known = {f.name: f for f in self.fields}
        unknown = sorted(set(payload) - set(known))
        if unknown:
            raise SchemaError(f"unknown payload keys {unknown}; "
                              f"schema fields are {sorted(known)}")
        out: Dict[str, Any] = {}
        for name, fld in known.items():
            if name in payload:
                out[name] = fld.validate(payload[name])
            elif fld.required:
                raise SchemaError(f"missing required field {name!r}")
        return out

    def to_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "vector": self.vector.to_dict(),
               "fields": [f.to_dict() for f in self.fields]}
        if self.batcher is not None:
            out["batcher"] = self.batcher.to_dict()
        # serialized only when non-default, so pre-cluster snapshots and
        # wire payloads stay byte-identical
        if self.shards != 1:
            out["shards"] = self.shards
        if self.replicas != 1:
            out["replicas"] = self.replicas
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CollectionSchema":
        batcher = d.get("batcher")
        if batcher is not None and not isinstance(batcher, dict):
            raise SchemaError(     # don't silently drop an operator's tuning
                f"batcher must be an object like "
                f"{{'max_batch': 32, 'max_wait_ms': 2.0}}, got {batcher!r}")
        return cls(name=d["name"],
                   vector=VectorField.from_dict(d["vector"]),
                   fields=tuple(field_from_dict(f)
                                for f in d.get("fields", ())),
                   batcher=(BatcherConfig(**batcher) if batcher is not None
                            else None),
                   shards=d.get("shards", 1),
                   replicas=d.get("replicas", 1))
