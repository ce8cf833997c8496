"""Fault-tolerant checkpoint store (manifest + segments + WAL), in the JAX
package's on-disk format."""

from .store import (CheckpointStore, Manifest, ShardedCheckpoint,
                    replay_wal_into, reshard_rows)
