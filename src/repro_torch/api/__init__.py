"""Quantixar public API on the port: schema-driven vector data management.

    from repro_torch.api import (Database, CollectionSchema, VectorField,
                                 KeywordField, NumericField)

    db = Database()                       # the card; Database(device="cpu")
    col = db.create_collection(CollectionSchema(
        name="docs",
        vector=VectorField(dim=128, metric="cosine", index="hnsw"),
        fields=(KeywordField("lang"), NumericField("stars"))))
    col.upsert(["doc-1"], vec[None, :], [{"lang": "en", "stars": 4}])
    hits = col.query(q).filter(lang="en").where("stars", "ge", 3).run()

Over the wire (the same surface, against `repro_torch.serving.http` or the
JAX package's server, which speak the same bytes):

    from repro_torch.api import QuantixarClient

    client = QuantixarClient("http://127.0.0.1:6333")
    col = client.collection("docs")
    hits = col.query(q).filter(lang="en").top_k(5).run()

The JAX package's ``repro.api`` over the port's engine: the same schemas,
fluent queries, declarative plans, wire dicts, HTTP client, sharded
collections and checkpoint layout.  Every entry point runs on the card
unless the caller asks for the CPU.
"""

from ..cluster.sharded import ShardedCollection, ShardUnavailable
from ..core.metadata import And, Filter, Not, Or, Predicate
from .client import QuantixarClient, RemoteCollection
from .collection import (Collection, CollectionClosed, Entity,
                         QueryRetriesExhausted)
from .database import Database
from .plan import (AnnStage, FusionStage, PlanExplain, PrefetchStage,
                   QueryPlan, RescoreStage, SparseStage, plan_from_dict,
                   plan_to_dict)
from .query import Hit, Query
from .requests import (ApiError, ErrorInfo, RemoteInvalidArgument,
                       RemoteNotFound, RemoteSchemaError, RemoteUnavailable)
from .schema import (BatcherConfig, BoolField, CollectionSchema, KeywordField,
                     MetadataField, NumericField, SchemaError, TextField,
                     VectorField)

__all__ = [
    "And", "Filter", "Not", "Or", "Predicate",
    "Collection", "CollectionClosed", "Entity", "Database", "Hit", "Query",
    "QueryRetriesExhausted", "ShardedCollection", "ShardUnavailable",
    "AnnStage", "FusionStage", "PlanExplain", "PrefetchStage", "QueryPlan",
    "RescoreStage", "SparseStage", "plan_from_dict", "plan_to_dict",
    "QuantixarClient", "RemoteCollection",
    "ApiError", "ErrorInfo", "RemoteInvalidArgument", "RemoteNotFound",
    "RemoteSchemaError", "RemoteUnavailable",
    "BatcherConfig", "BoolField", "CollectionSchema", "KeywordField",
    "MetadataField", "NumericField", "SchemaError", "TextField",
    "VectorField",
]
