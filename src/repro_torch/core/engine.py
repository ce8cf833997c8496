"""QuantixarEngine in PyTorch: entities in, similarity queries out.

The port of the JAX package's ``repro.core.engine`` for the unquantized
engine: ``index`` ∈ {hnsw, flat} with ``quantization="none"``, the segmented
write path (sealed index + exact-scanned delta segment, `SealPolicy` folds),
MEVS masks with the low-selectivity flat route, and ``state_dict`` /
``from_state_dict`` in the JAX engine's key layout, so a state saved by
either engine loads in the other.  PQ, BQ and IVF come with later slices and
raise `NotImplementedError` naming their ROADMAP item.

The engine runs on one torch device, the card unless the caller asks for
the CPU.  Raw vectors, metadata and the packed graph stay on the host, as in
the JAX package; the graph, the corpus for the flat route and the delta's
distance-space matrix live on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .executor import AnnParams
from .flat import flat_search
from .hnsw_build import (HNSWConfig, PackedHNSW, ProgressFn, build,
                         bulk_build, preprocess_vectors)
from .hnsw_bulk import bulk_build_device
from .hnsw_search import search as hnsw_search
from .hnsw_search import to_device
from .metadata import Filter, MetadataStore
from .segment import (ChunkedArray, DeltaSegment, SealPolicy,
                      merge_candidates)

# Every float32 product of the port (exact kNN, flat scans, k-means, the
# plain versions) is held to the JAX package's float32 results.  TF32 keeps
# about three decimal digits, which reorders near neighbours, so it stays
# off for matmuls and for cuDNN whatever PyTorch's defaults become.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# corpus rows per block of the exact flat scan: bounds the (Q, rows)
# distance block on the device; finite results equal an unchunked scan's
FLAT_CHUNK = 65536


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item})")


@dataclasses.dataclass
class EngineConfig:
    dim: int
    metric: str = "cosine"               # default per paper §I
    index: str = "hnsw"                  # "hnsw" | "flat"
    quantization: str = "none"           # "none" in this slice
    hnsw: HNSWConfig = dataclasses.field(default_factory=HNSWConfig)
    # "incremental" (faithful one-at-a-time inserts) | "bulk" (device-
    # parallel batched build, core/hnsw_bulk.py) | "bulk_ref" (the slow
    # numpy exactness reference)
    builder: str = "incremental"
    ef_search: int = 64
    # wide-beam candidates popped per HNSW iteration; None defers to
    # hnsw.expansion_width (per-query override rides search())
    expansion_width: Optional[int] = None
    filter_flat_threshold: float = 0.10  # MEVS: selectivity below which we
    #                                      scan the filtered subset exactly
    seal: SealPolicy = dataclasses.field(default_factory=SealPolicy)

    def __post_init__(self):
        if self.index == "ivf":
            raise _not_ported("index='ivf'", "A8")
        if self.index not in ("hnsw", "flat"):
            raise ValueError(f"index {self.index!r}")
        if self.quantization in ("pq", "bq"):
            raise _not_ported(f"quantization={self.quantization!r}", "A3")
        if self.quantization != "none":
            raise ValueError(f"quantization {self.quantization!r}")
        if self.builder not in ("incremental", "bulk", "bulk_ref"):
            raise ValueError(f"builder {self.builder!r}")
        # HNSW metric follows the engine metric
        self.hnsw = dataclasses.replace(self.hnsw, metric=self.metric)


class QuantixarEngine:
    """The paper's "Quantixar Engine" on one torch device."""

    def __init__(self, config: EngineConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self._vectors = ChunkedArray()            # raw entity vectors (host)
        self._n = 0
        self.metadata = MetadataStore()
        self._packed: Optional[PackedHNSW] = None
        self._device_graph = None                  # (HNSWGraph, max_level, metric)
        self._dirty = True          # no usable sealed segment yet: build first
        self._sealed_n = 0          # rows covered by the sealed segment
        self._delta: Optional[DeltaSegment] = None  # exists once sealed
        self._delta_cache = None    # (delta, version, eff_device, metric)
        self._corpus_cache = None   # (n, raw corpus on the device)
        self.build_seconds: float = 0.0
        self.insert_seconds: float = 0.0
        # observability for the segmented write path: a post-build add() must
        # bump none of these; seal() bumps seal/index
        self.index_builds = 0
        self.quantizer_trains = 0   # stays 0: no quantizers in this slice
        self.seals = 0

    # ------------------------------------------------------------------ data
    def __len__(self) -> int:
        return self._n

    @property
    def vectors(self) -> np.ndarray:
        v = self._vectors.view()
        return v if v is not None \
            else np.zeros((0, self.config.dim), dtype=np.float32)

    @property
    def delta_rows(self) -> int:
        return len(self._delta) if self._delta is not None else 0

    def add(self, vectors: np.ndarray,
            metadata: Optional[Sequence[Optional[Dict[str, Any]]]] = None) -> None:
        """Insert a batch of entities (vector + optional metadata record).

        Before the first `build()` this only appends (the build is lazy).
        After it, the batch lands in the delta segment: the sealed graph is
        untouched and the rows are immediately searchable via the exact
        delta scan.  The seal policy may then fold the delta.
        """
        t0 = time.perf_counter()
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.config.dim:
            raise ValueError(
                f"expected (n, {self.config.dim}) vectors, got {vectors.shape}")
        if metadata is None:
            metadata = [None] * len(vectors)
        if len(metadata) != len(vectors):
            raise ValueError("metadata length mismatch")
        self._vectors.append(vectors)
        self._n += len(vectors)
        self.metadata.append_batch(metadata)
        if self._dirty or self._delta is None:
            self._dirty = True                    # first build covers everything
        else:
            self._delta.append(vectors)
            if self.config.seal.auto and self.config.seal.should_seal(
                    self._sealed_n, len(self._delta)):
                self.seal()
        self.insert_seconds += time.perf_counter() - t0

    # ----------------------------------------------------------------- build
    def build(self, seed: int = 0,
              progress: Optional[ProgressFn] = None) -> None:
        """Build the index over everything inserted so far (the full O(N)
        path).  ``progress`` is an optional ``(phase, done, total)``
        callback threaded through to the graph builder."""
        t0 = time.perf_counter()
        raw = self.vectors
        if len(raw) == 0:
            raise RuntimeError("nothing to build: add() vectors first")
        self._build_index(raw, seed, progress=progress)
        self._mark_sealed()
        self._dirty = False
        self.build_seconds = time.perf_counter() - t0

    def seal(self, seed: int = 0,
             progress: Optional[ProgressFn] = None) -> bool:
        """Fold the delta segment into a new sealed segment (rebuilds the
        index structure).  Returns True if anything changed."""
        if self._dirty or self._delta is None:
            if self._n == 0:
                return False                # nothing inserted yet
            self.build(seed, progress=progress)  # never built
            return True
        if len(self._delta) == 0:
            return False
        t0 = time.perf_counter()
        self._build_index(self.vectors, seed, progress=progress)
        self._mark_sealed()
        self.seals += 1
        self.build_seconds = time.perf_counter() - t0
        return True

    def _mark_sealed(self) -> None:
        self._sealed_n = self._n
        self._delta = DeltaSegment(start=self._n, dim=self.config.dim)
        self._delta_cache = None

    def _build_index(self, raw: np.ndarray, seed: int,
                     progress: Optional[ProgressFn] = None) -> None:
        cfg = self.config
        if cfg.index == "hnsw":
            builder = {"incremental": build,
                       "bulk": functools.partial(bulk_build_device,
                                                 device=self.device),
                       "bulk_ref": bulk_build}[cfg.builder]
            self._packed = builder(raw, cfg.hnsw, progress=progress)
            self._device_graph = to_device(self._packed, self.device)
        else:
            self._packed = None
            self._device_graph = None
        self.index_builds += 1

    # ---------------------------------------------------------------- search
    def search(self, queries: np.ndarray, k: int,
               flt: Optional[Filter] = None,
               ef: Optional[int] = None,
               mask: Optional[np.ndarray] = None,
               rescore: Optional[bool] = None,
               expansion_width: Optional[int] = None,
               params: Optional[AnnParams] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k similarity search (Vector Query / MEVS).

        `mask` is an optional precomputed (N,) bool row mask AND-ed with the
        metadata filter.  `expansion_width` overrides the configured
        wide-beam width (1 == classic single-pop).  `params` carries ef /
        expansion_width / rescore as one `AnnParams` struct, exclusive with
        the keywords.  `rescore` only acts on quantized engines, so it is
        accepted and has no effect here.

        The sealed segment is searched through its index; a non-empty delta
        segment is exact-scanned in the same distance space and merged.

        Returns (distances (Q,k) in the engine metric, ids (Q,k); -1 = none).
        """
        if params is not None:
            if (ef, rescore, expansion_width) != (None, None, None):
                raise ValueError(
                    "pass ef/rescore/expansion_width either as keywords or "
                    "inside params=AnnParams(...), not both")
            ef, expansion_width = params.ef, params.expansion_width
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self._dirty:
            self.build()
        cfg = self.config
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        ef = ef if ef is not None else max(cfg.ef_search, k)
        flt_mask = self.metadata.evaluate(flt) if flt is not None else None
        if mask is not None:
            mask = np.asarray(mask, dtype=bool)
            mask = flt_mask & mask if flt_mask is not None else mask
        else:
            mask = flt_mask

        if cfg.index == "flat" or self._route_to_flat(mask):
            d, ids = self._flat_pass(queries, k, mask)
        else:
            d, ids = self._hnsw_pass(queries, k, ef, mask, expansion_width)
            if self.delta_rows:
                dd, dids = self._delta_pass(queries, k, mask)
                d, ids = merge_candidates(d, ids, dd, dids, k)
            if mask is not None and (ids[:, : min(k, ids.shape[1])] == -1).any():
                # beam under-delivered under the filter: exact masked scan
                d, ids = self._flat_pass(queries, k, mask)
        d, ids = d[:, :k], ids[:, :k]
        # contract: +inf slots (masked-out / padded) never expose a row id
        return d, np.where(np.isfinite(d), ids, -1)

    def _route_to_flat(self, mask: Optional[np.ndarray]) -> bool:
        """MEVS routing (paper: filter first, then search the subset): at low
        selectivity an exact masked scan is both faster and exact."""
        if mask is None:
            return False
        sel = mask.mean() if len(mask) else 0.0
        return sel <= self.config.filter_flat_threshold

    def _corpus_device(self) -> torch.Tensor:
        """All raw vectors on the device, cached until the next add()."""
        if self._corpus_cache is None or self._corpus_cache[0] != self._n:
            self._corpus_cache = (
                self._n, torch.as_tensor(self.vectors).to(self.device))
        return self._corpus_cache[1]

    def _flat_pass(self, queries, k, mask):
        mask_t = None if mask is None else \
            torch.as_tensor(mask).to(self.device)
        d, ids = flat_search(torch.as_tensor(queries).to(self.device),
                             self._corpus_device(), min(k, self._n),
                             metric=self.config.metric, chunk=FLAT_CHUNK,
                             mask=mask_t)
        return d.cpu().numpy(), ids.cpu().numpy()

    def _hnsw_pass(self, queries, k, ef, mask, expansion_width=None):
        """Wide-beam-search the sealed graph only (delta rows merge
        separately); layer-0 distances go through the beam_gather kernel."""
        cfg = self.config
        g, max_level, metric = self._device_graph
        n_sealed = self._packed.n
        width = self.effective_expansion_width(expansion_width)
        ef_eff = max(ef, k)
        if mask is not None:
            ef_eff = min(max(ef_eff * 2, k * 4), n_sealed)
        q = preprocess_vectors(queries, cfg.metric) if metric == "dot" \
            else queries
        d, ids = hnsw_search(g, torch.as_tensor(q).to(self.device),
                             k=min(ef_eff, n_sealed), ef=min(ef_eff, n_sealed),
                             max_level=max_level, metric=metric,
                             expansion_width=width)
        d, ids = self._apply_mask(d.cpu().numpy(), ids.cpu().numpy(), mask,
                                  n_sealed)
        return d[:, :k], ids[:, :k]

    def effective_expansion_width(self, override: Optional[int] = None) -> int:
        """Per-query override > EngineConfig.expansion_width > HNSWConfig."""
        width = (override if override is not None
                 else self.config.expansion_width
                 if self.config.expansion_width is not None
                 else self.config.hnsw.expansion_width)
        if width < 1:
            raise ValueError(f"expansion_width must be >= 1, got {width}")
        return int(width)

    @staticmethod
    def _apply_mask(d, ids, mask, n_rows):
        """Demote masked-out candidates to +inf/-1 and re-sort.  `mask` is
        corpus-global; candidate ids come from the sealed structure, so only
        its first `n_rows` entries apply (-1 padding maps to False)."""
        if mask is None:
            return d, ids
        allowed = np.concatenate([mask[:n_rows], [False]])
        ok = allowed[ids]
        d = np.where(ok, d, np.inf)
        order = np.argsort(d, axis=1, kind="stable")
        d = np.take_along_axis(d, order, axis=1)
        ids = np.where(np.take_along_axis(ok, order, axis=1),
                       np.take_along_axis(ids, order, axis=1), -1)
        return d, ids

    def _delta_pass(self, queries, k, mask):
        """Exact scan of the delta segment in the sealed pass's distance
        space (preprocessed raw vectors, "dot" for cosine/dot, "l2" for l2),
        so `merge_candidates` can interleave the two lists directly.
        Returned ids are global (delta start offset applied)."""
        delta = self._delta
        n_d = len(delta)
        eff_dev, metric = self._delta_effective()
        q = preprocess_vectors(queries, self.config.metric)
        padded = int(eff_dev.shape[0])
        live = (np.ones(n_d, dtype=bool) if mask is None
                else np.asarray(mask[delta.start:], dtype=bool))
        if padded > n_d:
            live = np.concatenate([live, np.zeros(padded - n_d, dtype=bool)])
        d, ids = flat_search(torch.as_tensor(q).to(self.device), eff_dev,
                             min(k, padded), metric=metric,
                             mask=torch.as_tensor(live).to(self.device),
                             base_index=delta.start)
        return d.cpu().numpy(), ids.cpu().numpy()

    def _delta_effective(self):
        """Device-resident distance-space matrix for the delta scan, padded
        to a power of two as in the JAX package, cached per (segment,
        version).  Returns (device matrix, flat_search metric)."""
        delta = self._delta
        cached = self._delta_cache
        if (cached is not None and cached[0] is delta
                and cached[1] == delta.version):
            return cached[2], cached[3]
        eff = preprocess_vectors(delta.raw, self.config.metric)
        metric = "l2" if self.config.metric == "l2" else "dot"
        n_d = len(delta)
        padded = 1 << max(0, n_d - 1).bit_length()
        if padded > n_d:
            eff = np.concatenate(
                [eff, np.zeros((padded - n_d, eff.shape[1]), eff.dtype)])
        eff_dev = torch.as_tensor(eff).to(self.device)
        self._delta_cache = (delta, delta.version, eff_dev, metric)
        return eff_dev, metric

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        """The JAX engine's layout: vectors, n, sealed_n, dirty, hnsw.*,
        meta.* (numpy arrays)."""
        state: Dict[str, Any] = {
            "vectors": self.vectors,
            "n": np.array([self._n], dtype=np.int64),
            # rows in [0, sealed_n) are covered by the serialized index;
            # rows beyond it round-trip as the delta segment (no rebuild)
            "sealed_n": np.array([self._sealed_n], dtype=np.int64),
            "dirty": np.array([self._dirty]),
        }
        if self._packed is not None:
            state.update({f"hnsw.{k}": v
                          for k, v in self._packed.state_dict().items()})
        state.update({f"meta.{k}": v
                      for k, v in self.metadata.state_dict().items()})
        return state

    @classmethod
    def from_state_dict(cls, config: EngineConfig, state: Dict[str, Any],
                        device="cuda") -> "QuantixarEngine":
        """Rebuild an engine from a `state_dict` (the JAX engine's included):
        the same sealed graph and delta split, on ``device``."""
        for prefix, item in (("codes", "A3"), ("pq.", "A3"), ("bq.", "A3"),
                             ("ivf.", "A8")):
            if any(k.startswith(prefix) for k in state):
                raise _not_ported(f"a state with {prefix!r} entries", item)
        eng = cls(config, device=device)
        eng._vectors = ChunkedArray(
            [np.asarray(state["vectors"], dtype=np.float32)])
        eng._n = int(state["n"][0])
        eng.metadata = MetadataStore.from_state_dict(
            {k[5:]: v for k, v in state.items() if k.startswith("meta.")})
        sealed_n = int(state["sealed_n"][0]) if "sealed_n" in state else eng._n
        hnsw_state = {k[5:]: v for k, v in state.items()
                      if k.startswith("hnsw.")}
        if hnsw_state:
            eng._packed = PackedHNSW.from_state_dict(hnsw_state, config.hnsw)
            eng._device_graph = to_device(eng._packed, eng.device)
            eng._dirty = False
        elif config.index == "flat" and eng._n:
            eng._dirty = False
        if "dirty" in state and bool(state["dirty"][0]):
            eng._dirty = True
        if not eng._dirty:
            # reconstruct the segment split: sealed index + delta tail
            eng._sealed_n = sealed_n
            eng._delta = DeltaSegment(start=sealed_n, dim=config.dim)
            if eng._n > sealed_n:
                eng._delta.append(eng.vectors[sealed_n:])
        return eng

    def stats(self) -> Dict[str, Any]:
        out = {"n": self._n, "dim": self.config.dim,
               "index": self.config.index,
               "quantization": self.config.quantization,
               "metric": self.config.metric,
               "build_seconds": self.build_seconds,
               "insert_seconds": self.insert_seconds,
               "sealed_rows": self._sealed_n,
               "delta_rows": self.delta_rows,
               "index_builds": self.index_builds,
               "quantizer_trains": self.quantizer_trains,
               "seals": self.seals,
               "device": str(self.device)}
        if self.config.index == "hnsw":
            out["builder"] = self.config.builder
        if self._packed is not None:
            out.update(self._packed.degree_stats())
            out.update(self._packed.build_info)
        return out
