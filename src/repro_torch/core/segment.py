"""Segmented storage: mutable delta segment + sealed-segment merge policy.

Numpy-only copy of the JAX package's ``repro.core.segment``, kept here so the port
imports nothing of that package.

Production VDBMSs decouple ingest from index maintenance with segmented
storage (Pan et al. 2023: "Survey of Vector Database Management Systems";
Qdrant/Milvus ship the same shape): writes land in a small **delta segment**
served by an exact flat scan, while the **sealed segment** keeps its trained
quantizers and HNSW/IVF structure.  Queries fan out over both and merge
top-k; an explicit `seal()` folds the delta into a new sealed segment on an
amortized schedule instead of billing an O(N) rebuild to one unlucky query.

This module owns the delta-side bookkeeping:

  * `DeltaSegment` — the append-only mutable tail: raw vector chunks plus
    (when quantizer codebooks exist) their encode-only codes.  Rows keep
    *global* ids — `start + local offset` — so masks, metadata and rescore
    indexing stay corpus-wide.
  * `SealPolicy` — when to fold: absolute delta size or delta/sealed ratio.
  * `merge_candidates` — top-k merge of per-segment candidate lists that are
    already in one distance space (the engine guarantees the delta scan uses
    the sealed pass's traversal space; id ranges are disjoint by
    construction, so no dedup is needed).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SealPolicy:
    """When the mutable delta should be folded into a sealed segment.

    Either trigger suffices: an absolute row count (bounds the exact-scan
    cost at large corpora) or a delta/sealed ratio (bounds relative scan
    overhead at small ones).  `auto=False` restricts sealing to explicit
    `seal()` / `Collection.compact()` calls.
    """

    max_delta_rows: int = 10000
    max_delta_ratio: float = 0.5
    auto: bool = True

    def should_seal(self, sealed_rows: int, delta_rows: int) -> bool:
        if delta_rows <= 0:
            return False
        if delta_rows >= self.max_delta_rows:
            return True
        return sealed_rows > 0 and delta_rows >= self.max_delta_ratio * sealed_rows


class ChunkedArray:
    """Append-only row store: chunks in, one array out, concatenated lazily.

    Every write-path buffer in the engine has this access pattern (raw
    vectors, code matrices, the delta's copies of both): O(batch) appends,
    occasional whole-array reads.  `view()` collapses the chunk list once
    and caches the result until the next append.
    """

    def __init__(self, chunks: Optional[List[np.ndarray]] = None):
        self._chunks: List[np.ndarray] = \
            [np.asarray(c) for c in (chunks or [])]

    def __bool__(self) -> bool:
        return bool(self._chunks)

    def append(self, arr: np.ndarray) -> None:
        self._chunks.append(np.asarray(arr))

    def view(self) -> Optional[np.ndarray]:
        """The concatenated array, or None when nothing was appended."""
        if not self._chunks:
            return None
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks, axis=0)]
        return self._chunks[0]


class DeltaSegment:
    """Mutable write segment: post-build inserts, exact-scanned at query time.

    Stores references to the raw chunks the engine already holds (no copy)
    plus the encode-only codes for quantized engines.
    """

    def __init__(self, start: int, dim: int):
        self.start = int(start)          # first global row id in the delta
        self.dim = int(dim)
        self._raw = ChunkedArray()
        self._codes = ChunkedArray()
        self._n = 0
        self.version = 0                 # bumped per append: cache fencing

    def __len__(self) -> int:
        return self._n

    @property
    def stop(self) -> int:
        """One past the last global row id (== engine row count)."""
        return self.start + self._n

    def append(self, vectors: np.ndarray,
               codes: Optional[np.ndarray] = None) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(
                f"expected (n, {self.dim}) vectors, got {vectors.shape}")
        if codes is not None and len(codes) != len(vectors):
            raise ValueError("codes/vectors length mismatch")
        if self._codes and codes is None:
            raise ValueError("segment has codes; batch arrived without")
        if len(vectors) == 0:
            return
        self._raw.append(vectors)
        if codes is not None:
            self._codes.append(codes)
        self._n += len(vectors)
        self.version += 1

    @property
    def raw(self) -> np.ndarray:
        v = self._raw.view()
        return v if v is not None \
            else np.zeros((0, self.dim), dtype=np.float32)

    @property
    def codes(self) -> Optional[np.ndarray]:
        return self._codes.view()


def merge_candidates(d_a: np.ndarray, i_a: np.ndarray,
                     d_b: np.ndarray, i_b: np.ndarray,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two (Q, ka)/(Q, kb) candidate lists into the best-k (ascending).

    Both lists must be in the same distance space and carry disjoint global
    id ranges (sealed rows < delta rows).  +inf slots sink to the tail and
    surface as id -1, matching the engine's padding contract.
    """
    d = np.concatenate([np.asarray(d_a, dtype=np.float32),
                        np.asarray(d_b, dtype=np.float32)], axis=1)
    i = np.concatenate([np.asarray(i_a), np.asarray(i_b)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(d, order, axis=1)
    i = np.take_along_axis(i, order, axis=1)
    return d, np.where(np.isfinite(d), i, -1).astype(np.int32)
