"""Checkpoint store: manifest + sharded segments (DESIGN.md §2, storage row).

Plays the RocksDB/etcd role of the paper with the same interface split:

  * local mode  — one host, segments under a single directory (RocksDB role:
    fast local persistence).
  * sharded mode — each host writes only its shard's segments + a per-shard
    manifest; a coordinator (host 0) commits the global manifest (etcd role:
    the manifest is the consistent, versioned source of truth).

Fault-tolerance contract:
  * atomic commits — segments are written to a staging dir, fsync'd, then the
    manifest is atomically renamed in; a crash mid-write never corrupts the
    last committed generation.
  * generations — every commit gets a monotonically increasing generation id;
    `latest()` resolves the newest complete one; older generations are kept
    (bounded by `keep`) for rollback.
  * WAL — `wal_append()` persists insert batches between index rebuilds;
    recovery = load last generation + replay WAL segments.
  * elastic reshard — the corpus is row-partitioned, so loading N-shard data
    onto M shards is a deterministic concat+resplit (`load_resharded`).

Carried across from the JAX package's ``repro.checkpoint.store``
unchanged: it is numpy and stdlib code, and the on-disk format (manifest
JSON, one ``.npy`` per array, WAL segments) is the same, so a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

MANIFEST = "MANIFEST.json"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_array(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr, allow_pickle=arr.dtype == object)
        f.flush()
        os.fsync(f.fileno())


def _load_array(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=True)


@dataclasses.dataclass
class Manifest:
    generation: int
    step: int
    created_unix: float
    num_shards: int
    arrays: Dict[str, Dict[str, Any]]   # key -> {file, shape, dtype, shard}
    wal_segments: List[str]
    extra: Dict[str, Any]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        return cls(**json.loads(text))


class CheckpointStore:
    """Directory layout:

        root/
          gen-000001/MANIFEST.json + *.npy     (committed generations)
          wal/wal-<t>.npz                      (insert log since last commit)
    """

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        os.makedirs(self.wal_dir, exist_ok=True)
        self._lock = threading.Lock()
        # separate lock: _lock is held for a whole commit's IO, and
        # save_async must stay non-blocking while a commit is in flight
        self._threads_lock = threading.Lock()
        self._async_threads: List[threading.Thread] = []  # guarded-by: _threads_lock

    # ------------------------------------------------------------ layout
    @property
    def wal_dir(self) -> str:
        return os.path.join(self.root, "wal")

    def _gen_dir(self, gen: int) -> str:
        return os.path.join(self.root, f"gen-{gen:06d}")

    def generations(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("gen-"):
                mpath = os.path.join(self.root, name, MANIFEST)
                if os.path.exists(mpath):      # complete commits only
                    out.append(int(name[4:]))
        return sorted(out)

    def latest(self) -> Optional[int]:
        gens = self.generations()
        return gens[-1] if gens else None

    # ------------------------------------------------------------ commit
    def save(self, state: Dict[str, np.ndarray], *, step: int = 0,
             shard_id: int = 0, num_shards: int = 1,
             extra: Optional[Dict[str, Any]] = None,
             clear_wal: bool = True) -> int:
        """Commit a new generation atomically. Returns the generation id."""
        with self._lock:
            gen = (self.latest() or 0) + 1
            stage = tempfile.mkdtemp(prefix=f".stage-{gen}-", dir=self.root)
            try:
                arrays = {}
                for key, arr in state.items():
                    arr = np.asarray(arr)
                    fname = key.replace("/", "__") + f".shard{shard_id}.npy"
                    _save_array(os.path.join(stage, fname), arr)
                    arrays[key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype), "shard": shard_id}
                while True:
                    man = Manifest(generation=gen, step=step,
                                   created_unix=time.time(),
                                   num_shards=num_shards, arrays=arrays,
                                   wal_segments=[], extra=extra or {})
                    # manifest written last => staging dir valid only now
                    with open(os.path.join(stage, MANIFEST), "w") as f:
                        f.write(man.to_json())
                        f.flush()
                        os.fsync(f.fileno())
                    try:
                        os.rename(stage, self._gen_dir(gen))   # atomic publish
                        break
                    except OSError as e:
                        if e.errno not in (errno.ENOTEMPTY, errno.EEXIST):
                            raise          # real IO failure, not a gen race
                        # another store instance over the same root claimed
                        # this generation between latest() and rename — a
                        # committed gen dir is never empty, so the rename
                        # refuses; take the next slot and re-stamp
                        gen += 1
                _fsync_dir(self.root)
            except BaseException:
                shutil.rmtree(stage, ignore_errors=True)
                raise
            if clear_wal:
                self._clear_wal()
            self._gc()
            return gen

    def save_async(self, state: Dict[str, np.ndarray], **kw) -> threading.Thread:
        """Non-blocking commit: snapshot is taken synchronously (cheap — numpy
        copies), IO happens in a background thread (the async-checkpoint
        pattern: training never stalls on storage)."""
        snapshot = {k: np.array(v, copy=True) for k, v in state.items()}
        t = threading.Thread(target=self.save, args=(snapshot,), kwargs=kw,
                             daemon=True)
        t.start()
        with self._threads_lock:
            self._async_threads.append(t)
        return t

    def wait_async(self) -> None:
        # snapshot under the lock, join OUTSIDE it: the background save()
        # acquires the commit lock, and holding any store lock across a
        # join invites an order cycle with it
        with self._threads_lock:
            threads, self._async_threads = self._async_threads, []
        for t in threads:
            t.join()

    def _gc(self) -> None:
        gens = self.generations()
        for g in gens[: max(0, len(gens) - self.keep)]:
            shutil.rmtree(self._gen_dir(g), ignore_errors=True)

    # ------------------------------------------------------------- load
    def load(self, gen: Optional[int] = None) -> Dict[str, np.ndarray]:
        gen = gen if gen is not None else self.latest()
        if gen is None:
            raise FileNotFoundError(f"no committed generation under {self.root}")
        gdir = self._gen_dir(gen)
        with open(os.path.join(gdir, MANIFEST)) as f:
            man = Manifest.from_json(f.read())
        return {key: _load_array(os.path.join(gdir, info["file"]))
                for key, info in man.arrays.items()}

    def manifest(self, gen: Optional[int] = None) -> Manifest:
        gen = gen if gen is not None else self.latest()
        if gen is None:
            raise FileNotFoundError(
                f"no committed generation under {self.root}")
        with open(os.path.join(self._gen_dir(gen), MANIFEST)) as f:
            return Manifest.from_json(f.read())

    # ------------------------------------------------------------- WAL
    def wal_append(self, vectors: np.ndarray,
                   metadata_json: Optional[str] = None) -> str:
        """Persist an insert batch; replayed on recovery until next commit."""
        fname = os.path.join(
            self.wal_dir, f"wal-{time.time_ns():020d}.npz")
        tmp = fname + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, vectors=np.asarray(vectors, dtype=np.float32),
                     metadata=np.array(metadata_json or "null"))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, fname)
        return fname

    def wal_replay(self) -> List[Dict[str, Any]]:
        out = []
        for name in sorted(os.listdir(self.wal_dir)):
            if not name.endswith(".npz"):
                continue
            with np.load(os.path.join(self.wal_dir, name),
                         allow_pickle=True) as z:
                meta = json.loads(str(z["metadata"]))
                out.append({"vectors": z["vectors"], "metadata": meta})
        return out

    def _clear_wal(self) -> None:
        for name in os.listdir(self.wal_dir):
            if name.endswith(".npz"):
                os.remove(os.path.join(self.wal_dir, name))


def replay_wal_into(store: "CheckpointStore", engine) -> int:
    """Replay WAL insert batches into anything with `add(vectors, metadata)`
    (a `QuantixarEngine`, typically restored via `from_state_dict`).

    With the segmented write path the replayed rows land in the engine's
    delta segment: crash recovery = load last generation + replay — no
    quantizer retraining and no sealed-graph rebuild.  Returns rows replayed.
    """
    n = 0
    for seg in store.wal_replay():
        engine.add(seg["vectors"], seg["metadata"])
        n += len(seg["vectors"])
    return n


# ---------------------------------------------------------------------------
# Elastic resharding (row-partitioned corpora)
# ---------------------------------------------------------------------------

def reshard_rows(shards: Sequence[np.ndarray], new_num: int) -> List[np.ndarray]:
    """N-shard row partition -> M-shard row partition (order-preserving)."""
    full = np.concatenate(list(shards), axis=0)
    bounds = np.linspace(0, len(full), new_num + 1).astype(int)
    return [full[bounds[i]: bounds[i + 1]] for i in range(new_num)]


class ShardedCheckpoint:
    """Per-shard stores + coordinator commit (multi-host posture).

    Each shard writes independently (parallel IO); `commit()` on the
    coordinator records the set of shard-generations that constitute one
    consistent global snapshot.
    """

    def __init__(self, root: str, num_shards: int, keep: int = 3):
        self.root = root
        self.num_shards = num_shards
        self.stores = [CheckpointStore(os.path.join(root, f"shard-{i:04d}"),
                                       keep=keep)
                       for i in range(num_shards)]
        os.makedirs(root, exist_ok=True)

    def save_shard(self, shard_id: int, state: Dict[str, np.ndarray],
                   step: int = 0) -> int:
        return self.stores[shard_id].save(
            state, step=step, shard_id=shard_id, num_shards=self.num_shards)

    def commit(self, step: int, shard_gens: Sequence[int]) -> None:
        doc = {"step": step, "unix": time.time(),
               "shard_generations": list(map(int, shard_gens)),
               "num_shards": self.num_shards}
        tmp = os.path.join(self.root, ".global.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.root, "GLOBAL.json"))

    def load_global(self) -> Dict[str, Any]:
        with open(os.path.join(self.root, "GLOBAL.json")) as f:
            return json.load(f)

    def load_resharded(self, key: str, new_num: int) -> List[np.ndarray]:
        """Load array `key` from all shards and repartition to `new_num`."""
        glob = self.load_global()
        parts = [self.stores[i].load(glob["shard_generations"][i])[key]
                 for i in range(glob["num_shards"])]
        return reshard_rows(parts, new_num)
