"""Clustered serving: hash-slot routing + sharded, replicated collections.

`ShardedCollection` partitions one logical collection across N in-process
engine shards (x R replicas) behind the exact `Collection` API; `Router`
owns the id -> hash slot -> shard mapping that makes rebalancing a routing
-table edit instead of a full rehash.
"""

from .router import HASH_SLOTS, Router, slot_of
from .sharded import ShardedCollection, ShardUnavailable

__all__ = ["HASH_SLOTS", "Router", "ShardedCollection", "ShardUnavailable",
           "slot_of"]
