"""Hash-slot routing: string id -> slot -> shard.

Entities are partitioned by a fixed-size hash-slot space (Redis-cluster
style) rather than `hash(id) % num_shards`: the id -> slot mapping is
immutable, so rebalancing moves *slots* between shards (a small routing
table update plus the rows in the moved slots) instead of rehashing the
whole corpus.  `blake2b` keys the slot so routing is deterministic across
processes and Python runs (`hash()` is salted per process).

Carried across from the JAX package's ``repro.cluster.router`` unchanged:
the slot hash is the reference's byte for byte, so a checkpoint's slot map
means the same in both packages.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

HASH_SLOTS = 64


def slot_of(id: str) -> int:
    """Deterministic id -> slot in [0, HASH_SLOTS)."""
    digest = hashlib.blake2b(id.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big") % HASH_SLOTS


class Router:
    """Immutable slot -> shard routing table."""

    def __init__(self, slot_map: Sequence[int]):
        slot_map = [int(s) for s in slot_map]
        if len(slot_map) != HASH_SLOTS:
            raise ValueError(f"slot_map must cover all {HASH_SLOTS} slots, "
                             f"got {len(slot_map)}")
        self.num_shards = max(slot_map) + 1
        if min(slot_map) < 0:
            raise ValueError("slot_map entries must be >= 0")
        if set(slot_map) != set(range(self.num_shards)):
            raise ValueError("every shard in [0, max] must own >= 1 slot")
        self.slot_map = tuple(slot_map)

    @classmethod
    def even(cls, num_shards: int) -> "Router":
        """Round-robin slot assignment (the create-time default)."""
        if not 1 <= num_shards <= HASH_SLOTS:
            raise ValueError(f"num_shards must be in [1, {HASH_SLOTS}], "
                             f"got {num_shards}")
        return cls([s % num_shards for s in range(HASH_SLOTS)])

    def shard_of(self, id: str) -> int:
        return self.slot_map[slot_of(id)]

    def partition(self, ids: Sequence[str]) -> Dict[int, List[int]]:
        """Batch indices grouped by owning shard (batch order preserved
        within each group — seq assignment depends on this)."""
        parts: Dict[int, List[int]] = {}
        for idx, id_ in enumerate(ids):
            parts.setdefault(self.shard_of(id_), []).append(idx)
        return parts

    def slots_of_shard(self, shard: int) -> List[int]:
        return [slot for slot, s in enumerate(self.slot_map) if s == shard]

    # ------------------------------------------------------------ rebalance
    def moved(self, slot: int, to_shard: int) -> "Router":
        """Routing table with one slot reassigned (shard move primitive)."""
        if not 0 <= slot < HASH_SLOTS:
            raise ValueError(f"slot must be in [0, {HASH_SLOTS}), got {slot}")
        new = list(self.slot_map)
        new[slot] = to_shard
        return Router(new)

    def split(self, shard: int) -> "Router":
        """Give the second half of `shard`'s slots to a new shard appended
        at index `num_shards` (scale-out primitive)."""
        slots = self.slots_of_shard(shard)
        if len(slots) < 2:
            raise ValueError(f"shard {shard} owns {len(slots)} slot(s); "
                             f"need >= 2 to split")
        new = list(self.slot_map)
        for slot in slots[len(slots) // 2:]:
            new[slot] = self.num_shards
        return Router(new)
