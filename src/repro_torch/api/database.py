"""`Database`: named collections + save/load through the checkpoint store.

One `Database` manages many named `Collection`s and persists them as a
single atomic checkpoint generation: every collection's engine state and
id/tombstone maps become namespaced arrays, and the declarative schemas ride
in the manifest's `extra` JSON — so `Database.load(path)` reconstructs the
full typed API surface (schemas included) from disk alone.

`Database` is the embedded twin of `QuantixarClient`: both hand out
collections whose reads (fluent `Query`, `count`, `recommend`, explicit
`QueryPlan`s) run the same declarative plan pipeline — the client ships the
compiled plan over the wire, a `Database` collection executes it in
process — so scenarios move between the two backends without rewrites.

Carried across from the JAX package's ``repro.api.database``; the one change
is the torch ``device`` every collection runs on, every shard and replica
engine of a sharded one included: the card unless the caller asks for the
CPU (``Database(path, device=...)``, ``Database.load(path, device=...)``).
The checkpoint layout is the JAX package's, so a database saved by either
package, sharded collections included, loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

from ..checkpoint.store import CheckpointStore
from ..cluster.sharded import ShardedCollection
from .collection import Collection
from .schema import (BatcherConfig, CollectionSchema, MetadataField,
                     SchemaError, VectorField)

_SEP = "/"          # namespaces collection arrays inside one checkpoint

# a sharded collection quacks like a Collection everywhere the database
# (and the serving plane above it) touches one
AnyCollection = Union[Collection, ShardedCollection]


def _build_collection(schema: CollectionSchema,
                      device="cuda") -> AnyCollection:
    """Topology dispatch: `shards`/`replicas` in the schema pick the
    engine shape; everything above sees one `Collection`-shaped object."""
    if schema.shards > 1 or schema.replicas > 1:
        return ShardedCollection(schema, device=device)
    return Collection(schema, device=device)


class Database:
    def __init__(self, path: Optional[str] = None, device="cuda"):
        self.path = path
        self.device = device
        self._collections: Dict[str, AnyCollection] = {}
        self._store = CheckpointStore(path) if path else None

    # ------------------------------------------------------------ management
    def create_collection(
            self,
            schema: Optional[CollectionSchema] = None, *,
            name: Optional[str] = None,
            vector: Optional[VectorField] = None,
            fields: Sequence[MetadataField] = (),
            batcher: Optional[BatcherConfig] = None,
            shards: int = 1, replicas: int = 1) -> AnyCollection:
        """Create from a full `CollectionSchema`, or from name/vector/fields
        keyword parts; `batcher=` tunes the serving-batcher knobs
        (`BatcherConfig(max_batch=..., max_wait_ms=...)`).  `shards`/
        `replicas` > 1 build a hash-partitioned `ShardedCollection` behind
        the same API."""
        if schema is None:
            if name is None or vector is None:
                raise SchemaError(
                    "pass a CollectionSchema or name= and vector=")
            schema = CollectionSchema(name=name, vector=vector,
                                      fields=tuple(fields), batcher=batcher,
                                      shards=shards, replicas=replicas)
        else:
            if batcher is not None:
                schema = dataclasses.replace(schema, batcher=batcher)
            if shards != 1 or replicas != 1:
                schema = dataclasses.replace(schema, shards=shards,
                                             replicas=replicas)
        if schema.name in self._collections:
            raise SchemaError(f"collection {schema.name!r} already exists")
        col = _build_collection(schema, device=self.device)
        self._collections[schema.name] = col
        return col

    def collection(self, name: str) -> AnyCollection:
        if name not in self._collections:
            raise KeyError(f"no collection {name!r}; "
                           f"have {self.list_collections()}")
        return self._collections[name]

    __getitem__ = collection

    def __contains__(self, name: str) -> bool:
        return name in self._collections

    def list_collections(self) -> List[str]:
        return sorted(self._collections)

    def drop_collection(self, name: str) -> None:
        col = self._collections.pop(name, None)
        if col is None:
            raise KeyError(f"no collection {name!r}")
        col.close()

    def close(self) -> None:
        for col in self._collections.values():
            col.close()

    # ----------------------------------------------------------- persistence
    def _resolve_store(self, path: Optional[str]) -> CheckpointStore:
        if path is not None:
            return CheckpointStore(path)
        if self._store is None:
            raise SchemaError(
                "no path: pass save(path=...) or Database(path=...)")
        return self._store

    def save(self, path: Optional[str] = None, *, step: int = 0) -> int:
        """Commit every collection atomically as one checkpoint generation.
        Returns the generation id."""
        store = self._resolve_store(path)
        state: Dict[str, Any] = {}
        schemas: Dict[str, Dict[str, Any]] = {}
        for name, col in self._collections.items():
            for key, arr in col.state_dict().items():
                state[f"{name}{_SEP}{key}"] = arr
            schemas[name] = col.schema.to_dict()
        return store.save(state, step=step,
                          extra={"quantixar_collections": schemas})

    @classmethod
    def load(cls, path: str, *, generation: Optional[int] = None,
             device="cuda") -> "Database":
        """Reconstruct a full database (schemas, engines, id maps) from the
        newest — or a specific — committed generation, on ``device``."""
        db = cls(path, device=device)
        store = db._store
        man = store.manifest(generation)
        schemas = man.extra.get("quantixar_collections")
        if schemas is None:
            raise SchemaError(
                f"checkpoint under {path!r} was not written by Database.save")
        state = store.load(generation)
        for name, schema_dict in schemas.items():
            schema = CollectionSchema.from_dict(schema_dict)
            prefix = f"{name}{_SEP}"
            sub = {k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix)}
            if schema.shards > 1 or schema.replicas > 1:
                db._collections[name] = ShardedCollection.from_state_dict(
                    schema, sub, device=device)
            else:
                db._collections[name] = Collection.from_state_dict(
                    schema, sub, device=device)
        return db

    def stats(self) -> Dict[str, Any]:
        return {name: col.stats() for name, col in self._collections.items()}
