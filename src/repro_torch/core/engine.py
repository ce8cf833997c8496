"""QuantixarEngine in PyTorch: entities in, similarity queries out.

The port of the JAX package's ``repro.core.engine``: ``index`` ∈ {hnsw,
flat, ivf} × ``quantization`` ∈ {none, pq, bq} × metric, the segmented write
path (sealed index + exact-scanned delta segment, `SealPolicy` folds), MEVS
masks with the low-selectivity flat route, the exact rescore of quantized
candidates, and ``state_dict`` / ``from_state_dict`` in the JAX engine's key
layout, so a state saved by either engine loads in the other.

Quantized HNSW: the graph is built over the float proxy vectors (PQ
reconstructions under l2, whose squared distance is the ADC distance; BQ ±1
signs under dot, whose negated product is 2·hamming − bits) and searched in
code domain: layer 0 gathers PQ codes / packed BQ words through the
``beam_gather_adc`` / ``beam_gather_hamming`` kernels, and the flat route
scans all codes through ``pq_adc`` / ``hamming``.  The exact scans (the
flat index, the unquantized flat route and every delta segment) run the
``l2_distance`` kernel through the metric registry.

IVF probes B5's fused ``l2_topk`` over the centroids and scans the probed
lists with ``beam_gather`` (`core/ivf.py`); as in the JAX package, IVF-PQ
scans reconstructions and IVF+BQ raw vectors.

The engine runs on one torch device, the card unless the caller asks for
the CPU.  Raw vectors, codes, metadata and the packed graph stay on the
host, as in the JAX package; the graph with its codes, the quantizers, the
IVF centroids, lists and prepped sealed rows, the corpus and codes for the
flat route and the rescore, and the delta's distance-space matrix live on
the device.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import bq as bq_mod
from . import pq as pq_mod
from .distances import normalize, rowwise
from .executor import AnnParams
from .flat import flat_search
from .hnsw_build import (HNSWConfig, PackedHNSW, ProgressFn, build,
                         bulk_build, preprocess_vectors)
from .hnsw_bulk import bulk_build_device
from .hnsw_search import search as hnsw_search
from .hnsw_search import to_device
from .ivf import IVFConfig, IVFIndex
from .metadata import Filter, MetadataStore
from .segment import (ChunkedArray, DeltaSegment, SealPolicy,
                      merge_candidates)

# Every float32 product of the port (exact kNN, flat scans, k-means, the
# plain versions) is held to the JAX package's float32 results.  TF32 keeps
# about three decimal digits, which reorders near neighbours, so it stays
# off for matmuls and for cuDNN whatever PyTorch's defaults become.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# corpus rows per block of every flat scan (exact, PQ, BQ): bounds the
# (Q, rows) distance block on the device; results equal an unchunked scan's
FLAT_CHUNK = 65536


@dataclasses.dataclass
class EngineConfig:
    dim: int
    metric: str = "cosine"               # default per paper §I
    index: str = "hnsw"                  # "hnsw" | "flat" | "ivf"
    quantization: str = "none"           # "none" | "pq" | "bq"
    pq: pq_mod.PQConfig = dataclasses.field(default_factory=pq_mod.PQConfig)
    bq: bq_mod.BQConfig = dataclasses.field(default_factory=bq_mod.BQConfig)
    hnsw: HNSWConfig = dataclasses.field(default_factory=HNSWConfig)
    ivf: IVFConfig = dataclasses.field(default_factory=IVFConfig)
    # "incremental" (faithful one-at-a-time inserts) | "bulk" (device-
    # parallel batched build, core/hnsw_bulk.py) | "bulk_ref" (the slow
    # numpy exactness reference)
    builder: str = "incremental"
    ef_search: int = 64
    # wide-beam candidates popped per HNSW iteration; None defers to
    # hnsw.expansion_width (per-query override rides search())
    expansion_width: Optional[int] = None
    rescore: bool = True                 # exact second pass for quantized search
    rescore_multiplier: int = 4          # first pass fetches k * multiplier
    filter_flat_threshold: float = 0.10  # MEVS: selectivity below which we
    #                                      scan the filtered subset exactly
    seal: SealPolicy = dataclasses.field(default_factory=SealPolicy)

    def __post_init__(self):
        if self.index not in ("hnsw", "flat", "ivf"):
            raise ValueError(f"index {self.index!r}")
        self.ivf = dataclasses.replace(self.ivf, metric=(
            "cosine" if self.metric == "cosine" else "l2"))
        if self.quantization not in ("none", "pq", "bq"):
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
        self._pq: Optional[pq_mod.ProductQuantizer] = None
        self._bq: Optional[bq_mod.BinaryQuantizer] = None
        # PQ codes (uint8, int32 for k > 256) or packed BQ words (int32)
        self._code_chunks = ChunkedArray()
        self._packed: Optional[PackedHNSW] = None
        self._device_graph = None                  # (HNSWGraph, max_level, metric)
        self._ivf: Optional[IVFIndex] = None
        self._ivf_corpus: Optional[torch.Tensor] = None  # prepped sealed rows
        self._dirty = True          # no usable sealed segment yet: build first
        self._sealed_n = 0          # rows covered by the sealed segment
        self._delta: Optional[DeltaSegment] = None  # exists once sealed
        self._delta_cache = None    # (delta, version, eff_device, metric)
        self._corpus_cache = None   # (n, raw corpus on the device)
        self._unit_cache = None     # (n, unit corpus rows on the device)
        self._codes_cache = None    # (n, codes on the device)
        self.build_seconds: float = 0.0
        self.insert_seconds: float = 0.0
        # observability for the segmented write path: a post-build add() must
        # bump none of these; seal() bumps seal/index, never quantizer_trains
        self.index_builds = 0       # HNSW-graph / IVF-list constructions
        self.quantizer_trains = 0   # PQ/BQ codebook (re)trainings
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
    def _codes(self) -> Optional[np.ndarray]:
        """Full-corpus code matrix (host), concatenated lazily: a post-build
        add() only appends its batch."""
        return self._code_chunks.view()

    @_codes.setter
    def _codes(self, value: Optional[np.ndarray]) -> None:
        self._code_chunks = ChunkedArray([] if value is None else [value])

    @property
    def delta_rows(self) -> int:
        return len(self._delta) if self._delta is not None else 0

    def add(self, vectors: np.ndarray,
            metadata: Optional[Sequence[Optional[Dict[str, Any]]]] = None) -> None:
        """Insert a batch of entities (vector + optional metadata record).

        Before the first `build()` this only appends (the build is lazy).
        After it, the batch lands in the delta segment: quantized engines
        encode the rows against the existing codebooks (no retraining), the
        sealed graph is untouched, and the rows are immediately searchable
        via the exact delta scan.  The seal policy may then fold the delta.
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
            codes = self._encode(vectors)
            self._delta.append(vectors, codes)
            if codes is not None:
                self._code_chunks.append(codes)
            if self.config.seal.auto and self.config.seal.should_seal(
                    self._sealed_n, len(self._delta)):
                self.seal()
        self.insert_seconds += time.perf_counter() - t0

    def _encode(self, vectors: np.ndarray) -> Optional[np.ndarray]:
        """Encode-only against trained codebooks (never retrains)."""
        q = self._pq or self._bq
        return None if q is None else q.encode(vectors).cpu().numpy()

    # ----------------------------------------------------------------- build
    def build(self, seed: int = 0,
              progress: Optional[ProgressFn] = None) -> None:
        """Train quantizers + build the index over everything inserted so
        far (the full O(N) path).  ``progress`` is an optional ``(phase,
        done, total)`` callback: ``("quantize", 1, 1)`` once the quantizer
        is trained and the corpus encoded, then the graph builder's own, or
        IVF's ``("kmeans", 1, 1)`` and ``("lists", 1, 1)``."""
        t0 = time.perf_counter()
        cfg = self.config
        raw = self.vectors
        if len(raw) == 0:
            raise RuntimeError("nothing to build: add() vectors first")
        self._pq = self._bq = None
        self._ivf = None                # a full build retrains the centroids
        if cfg.quantization == "pq":
            self._pq = pq_mod.ProductQuantizer(
                dataclasses.replace(cfg.pq, metric=(
                    "cosine" if cfg.metric == "cosine" else "l2")),
                device=self.device)
            self._pq.train(raw, seed=seed)
        elif cfg.quantization == "bq":
            self._bq = bq_mod.BinaryQuantizer(cfg.bq, device=self.device)
            self._bq.train(raw, seed=seed)
        self._codes = self._encode(raw)
        if self._codes is not None:
            self.quantizer_trains += 1
            if progress is not None:
                progress("quantize", 1, 1)
        self._build_index(raw, seed, progress=progress)
        self._mark_sealed()
        self._dirty = False
        self.build_seconds = time.perf_counter() - t0

    def seal(self, seed: int = 0,
             progress: Optional[ProgressFn] = None) -> bool:
        """Fold the delta segment into a new sealed segment (rebuilds the
        index structure; codebooks are reused).  Returns True if anything
        changed."""
        if self._dirty or self._delta is None:
            if self._n == 0:
                return False                # nothing inserted yet
            self.build(seed, progress=progress)  # never built: train + build
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
            eff, eff_metric = self._effective_vectors()
            builder = {"incremental": build,
                       "bulk": functools.partial(bulk_build_device,
                                                 device=self.device),
                       "bulk_ref": bulk_build}[cfg.builder]
            self._packed = builder(
                eff, dataclasses.replace(cfg.hnsw, metric=eff_metric),
                progress=progress)
            self._device_graph = self._to_device_graph()
        elif cfg.index == "ivf":
            # IVF-PQ scans probed lists over reconstructions (the ADC
            # identity); BQ's ±1 signs live in code space (bits != dim), so
            # IVF+BQ probes and scans raw vectors
            pq = cfg.quantization == "pq"
            raw_dev = self._to_dev(raw)      # one copy for every step
            if self._ivf is None or not self._ivf.is_trained:
                self._ivf = IVFIndex(dataclasses.replace(
                    cfg.ivf, metric="l2" if pq or cfg.metric != "cosine"
                    else "cosine"), device=self.device)
                self._ivf.train(raw_dev, seed=seed)
                if progress is not None:
                    progress("kmeans", 1, 1)
            self._ivf.build_lists(raw_dev)
            self._ivf_corpus = None          # free the stale copy first
            self._ivf_corpus = self._ivf.prep(
                self._pq.decode(self._codes) if pq else raw_dev)
            del raw_dev
            if progress is not None:
                progress("lists", 1, 1)
        else:
            self._packed = None
            self._device_graph = None
        self.index_builds += 1

    def _to_device_graph(self):
        """The sealed graph on the device; quantized engines ship their
        codes beside it for the code-domain layer-0 traversal."""
        codes = self._codes
        if codes is not None:
            codes = codes[: self._packed.n]
        return to_device(self._packed, self.device, codes=codes)

    def _effective_vectors(self) -> Tuple[np.ndarray, str]:
        """Vectors the graph is built over + its metric (see module doc)."""
        cfg = self.config
        if cfg.quantization == "pq":
            # ADC == L2 to the reconstruction (exact identity); cosine
            # inputs were normalized inside the quantizer already
            return self._pq.decode(self._codes).cpu().numpy(), "l2"
        if cfg.quantization == "bq":
            words = torch.as_tensor(self._codes).to(self.device)
            return bq_mod.signs(words, cfg.bq.bits).cpu().numpy(), "dot"
        return self.vectors, cfg.metric

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
        metadata filter.  `rescore` overrides the config's exact-rescore
        setting (quantized engines only).  `expansion_width` overrides the
        configured wide-beam width (1 == classic single-pop).  `params`
        carries ef / expansion_width / rescore as one `AnnParams` struct,
        exclusive with the keywords.

        The sealed segment is searched through its index; a non-empty delta
        segment is exact-scanned in the same distance space and merged.
        Masks and the rescore pass apply across the sealed+delta union.

        Returns (distances (Q,k) in the engine metric, ids (Q,k); -1 = none).
        """
        if params is not None:
            if (ef, rescore, expansion_width) != (None, None, None):
                raise ValueError(
                    "pass ef/rescore/expansion_width either as keywords or "
                    "inside params=AnnParams(...), not both")
            ef, rescore = params.ef, params.rescore
            expansion_width = params.expansion_width
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
        do_rescore = cfg.rescore if rescore is None else rescore
        do_rescore = do_rescore and cfg.quantization != "none"
        fetch = k * cfg.rescore_multiplier if do_rescore else k

        if cfg.index == "flat" or self._route_to_flat(mask):
            # the flat scan covers the whole corpus (delta rows included:
            # their codes were appended at insert time)
            d, ids = self._flat_pass(queries, fetch, mask)
        else:
            if cfg.index == "ivf":
                d, ids = self._ivf_pass(queries, fetch, mask)
            else:
                d, ids = self._hnsw_pass(queries, fetch, ef, mask,
                                         expansion_width)
            if self.delta_rows:
                dd, dids = self._delta_pass(queries, fetch, mask)
                d, ids = merge_candidates(d, ids, dd, dids, fetch)
            if mask is not None and \
                    (ids[:, : min(fetch, ids.shape[1])] == -1).any():
                # beam under-delivered under the filter: exact masked scan
                d, ids = self._flat_pass(queries, fetch, mask)
        if do_rescore:
            d, ids = self.exact_rescore(queries, ids, k, mask=mask)
        else:
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

    def _to_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _corpus_device(self) -> torch.Tensor:
        """All raw vectors on the device, cached until the next add()."""
        if self._corpus_cache is None or self._corpus_cache[0] != self._n:
            self._corpus_cache = (self._n, self._to_dev(self.vectors))
        return self._corpus_cache[1]

    def _unit_corpus_device(self) -> torch.Tensor:
        """All vectors as unit rows on the device (the cosine exact scan's
        corpus), normalized once and cached until the next add(); the raw
        rows are not kept beside them."""
        if self._unit_cache is None or self._unit_cache[0] != self._n:
            self._unit_cache = None          # free the stale copy first
            self._unit_cache = (self._n,
                                normalize(self._to_dev(self.vectors)))
        return self._unit_cache[1]

    def _codes_device(self) -> torch.Tensor:
        """All codes on the device, cached until the next add()."""
        if self._codes_cache is None or self._codes_cache[0] != self._n:
            self._codes_cache = (self._n, self._to_dev(self._codes))
        return self._codes_cache[1]

    def _flat_pass(self, queries, k, mask):
        """Masked scan of the whole corpus, FLAT_CHUNK rows at a time: ADC
        over the PQ codes (``pq_adc``), Hamming over the BQ words
        (``hamming``), or exact distances over the raw vectors."""
        cfg = self.config
        mask_t = None if mask is None else self._to_dev(mask)
        q = self._to_dev(queries)
        k = min(k, self._n)
        if cfg.quantization == "pq":
            d, ids = pq_mod.adc_topk(self._pq.lut(q), self._codes_device(),
                                     k, mask=mask_t, chunk=FLAT_CHUNK)
        elif cfg.quantization == "bq":
            d, ids = bq_mod.hamming_topk(self._bq.encode(q),
                                         self._codes_device(), k,
                                         mask=mask_t, chunk=FLAT_CHUNK)
        else:
            # on the card the cosine scan takes the cached unit rows (the
            # fused kernel scans the whole corpus at once; normalizing it on
            # every call would cost a transient (N, D) copy); on the CPU
            # each chunk is normalized as it is scanned
            unit = cfg.metric == "cosine" and q.device.type == "cuda"
            corpus = self._unit_corpus_device() if unit \
                else self._corpus_device()
            d, ids = flat_search(q, corpus, k, metric=cfg.metric,
                                 chunk=FLAT_CHUNK, mask=mask_t,
                                 unit_corpus=unit)
        return d.cpu().numpy(), ids.cpu().numpy()

    def _hnsw_pass(self, queries, k, ef, mask, expansion_width=None):
        """Wide-beam-search the sealed graph only (delta rows merge
        separately).  Unquantized engines gather float rows
        (``beam_gather``); PQ evaluates per-query ADC LUTs against the code
        matrix (``beam_gather_adc``), BQ XOR+popcounts packed words
        (``beam_gather_hamming``'s fused entry), never a float32
        reconstruction gather."""
        cfg = self.config
        g, max_level, metric = self._device_graph
        n_sealed = self._packed.n
        width = self.effective_expansion_width(expansion_width)
        ef_eff = max(ef, k)
        if mask is not None:
            ef_eff = min(max(ef_eff * 2, k * 4), n_sealed)
        q_codes = None
        if cfg.quantization == "bq":
            q_codes = self._bq.encode(queries)             # (Q, W) int32
            q = bq_mod.signs(q_codes, cfg.bq.bits)         # descent proxy
            metric = "hamming"
        elif cfg.quantization == "pq":
            q = preprocess_vectors(queries, "cosine") \
                if cfg.metric == "cosine" else queries
            q_codes = self._pq.lut(queries)                # (Q, m, k)
            metric = "adc"
        else:
            q = preprocess_vectors(queries, cfg.metric) if metric == "dot" \
                else queries
        d, ids = hnsw_search(g, self._to_dev(q), k=min(ef_eff, n_sealed),
                             ef=min(ef_eff, n_sealed), max_level=max_level,
                             metric=metric, expansion_width=width,
                             q_codes=q_codes)
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        if metric == "hamming":
            # back to the -dot space the delta scan / merge uses:
            # dot(±1) = bits - 2·hamming, so -dot = 2·hamming - bits (exact)
            d = np.where(np.isfinite(d), 2.0 * d - float(cfg.bq.bits), d)
        d, ids = self._apply_mask(d, ids, mask, n_sealed)
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

    def _ivf_pass(self, queries, k, mask):
        """Probe the sealed IVF lists only (delta rows merge separately),
        over the prepped sealed rows cached on the device."""
        d, ids = self._ivf.search_prepped(self._ivf_corpus, queries, k)
        d, ids = self._apply_mask(d.cpu().numpy(), ids.cpu().numpy(), mask,
                                  self._sealed_n)
        return d[:, :k], ids[:, :k]

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
        """Exact scan of the delta segment in the *sealed pass's* distance
        space, so `merge_candidates` can interleave the two lists directly:
        preprocessed raw vectors under the device metric (none), squared L2
        to reconstructions (pq, == ADC), -dot of ±1 signs (bq); for ivf,
        squared L2 of `IVFIndex.prep`-ed rows, the space `_ivf_search`
        scans the probed lists in.  Returned ids are global (delta start
        offset applied)."""
        cfg = self.config
        delta = self._delta
        n_d = len(delta)
        eff_dev, metric = self._delta_effective()
        if cfg.index == "ivf":
            q = self._ivf.prep(queries)
        elif cfg.quantization == "pq":
            q = preprocess_vectors(queries, "cosine") \
                if cfg.metric == "cosine" else queries
        elif cfg.quantization == "bq":
            q = bq_mod.signs(self._bq.encode(queries), cfg.bq.bits)
        else:
            q = preprocess_vectors(queries, cfg.metric)
        padded = int(eff_dev.shape[0])
        live = (np.ones(n_d, dtype=bool) if mask is None
                else np.asarray(mask[delta.start:], dtype=bool))
        if padded > n_d:
            live = np.concatenate([live, np.zeros(padded - n_d, dtype=bool)])
        d, ids = flat_search(self._to_dev(q), eff_dev, min(k, padded),
                             metric=metric, mask=self._to_dev(live),
                             base_index=delta.start)
        return d.cpu().numpy(), ids.cpu().numpy()

    def _delta_effective(self):
        """Device-resident distance-space matrix for the delta scan, padded
        to a power of two as in the JAX package, cached per (segment,
        version).  Returns (device matrix, flat_search metric)."""
        cfg = self.config
        delta = self._delta
        cached = self._delta_cache
        if (cached is not None and cached[0] is delta
                and cached[1] == delta.version):
            return cached[2], cached[3]
        if cfg.index == "ivf":
            eff = self._ivf.prep(self._pq.decode(delta.codes)
                                 if cfg.quantization == "pq" else delta.raw)
            metric = "l2"
        elif cfg.quantization == "pq":
            eff, metric = self._pq.decode(delta.codes), "l2"
        elif cfg.quantization == "bq":
            eff = bq_mod.signs(self._to_dev(delta.codes), cfg.bq.bits)
            metric = "dot"
        else:
            eff = self._to_dev(preprocess_vectors(delta.raw, cfg.metric))
            metric = "l2" if cfg.metric == "l2" else "dot"
        n_d = len(delta)
        padded = 1 << max(0, n_d - 1).bit_length()
        if padded > n_d:
            eff = torch.cat([eff, eff.new_zeros((padded - n_d,
                                                 eff.shape[1]))])
        self._delta_cache = (delta, delta.version, eff, metric)
        return eff, metric

    def exact_rescore(self, queries, cand_ids, k, mask=None):
        """Exact re-ranking of first-pass candidates in the engine metric,
        batched on the device: the (Q, k', D) candidate rows are gathered
        at once and scored by the metric's own formula.  The row mask is
        re-applied (exact distances would otherwise resurrect masked-out
        candidates that the first pass only demoted to +inf); the stable
        sort keeps the first-pass order among equal distances."""
        cand = self._to_dev(np.asarray(cand_ids)).long()
        safe = cand.clamp_min(0)
        d = rowwise(self.config.metric, self._to_dev(queries),
                    self._corpus_device()[safe])
        ok = cand >= 0
        if mask is not None:
            ok &= self._to_dev(mask)[safe]
        d = torch.where(ok, d, float("inf"))
        order = torch.sort(d, dim=1, stable=True).indices[:, :k]
        d = d.gather(1, order).cpu().numpy()
        ids = np.take_along_axis(np.asarray(cand_ids), order.cpu().numpy(),
                                 axis=1)
        return d, np.where(np.isfinite(d), ids, -1)

    # ----------------------------------------------------------- persistence
    def _codes_jax_layout(self) -> np.ndarray:
        """The code matrix as the JAX engine stores it: uint8 / uint16 PQ
        codes, uint32 BQ words."""
        codes = self._codes
        if self.config.quantization == "bq":
            return bq_mod.to_uint32(codes)
        return codes if codes.dtype == np.uint8 else codes.astype(np.uint16)

    def state_dict(self) -> Dict[str, Any]:
        """The JAX engine's layout: vectors, n, sealed_n, dirty, codes,
        pq.* / bq.*, hnsw.*, ivf.*, meta.* (numpy arrays)."""
        state: Dict[str, Any] = {
            "vectors": self.vectors,
            "n": np.array([self._n], dtype=np.int64),
            # rows in [0, sealed_n) are covered by the serialized index;
            # rows beyond it round-trip as the delta segment (no rebuild)
            "sealed_n": np.array([self._sealed_n], dtype=np.int64),
            "dirty": np.array([self._dirty]),
        }
        if self._codes is not None:
            state["codes"] = self._codes_jax_layout()
        for prefix, quantizer in (("pq", self._pq), ("bq", self._bq)):
            if quantizer is not None:
                state.update({f"{prefix}.{k}": v
                              for k, v in quantizer.state_dict().items()})
        if self._packed is not None:
            state.update({f"hnsw.{k}": v
                          for k, v in self._packed.state_dict().items()})
        if self._ivf is not None:
            state.update({f"ivf.{k}": v
                          for k, v in self._ivf.state_dict().items()})
        state.update({f"meta.{k}": v
                      for k, v in self.metadata.state_dict().items()})
        return state

    @classmethod
    def from_state_dict(cls, config: EngineConfig, state: Dict[str, Any],
                        device="cuda") -> "QuantixarEngine":
        """Rebuild an engine from a `state_dict` (the JAX engine's included):
        the same quantizers, codes, sealed graph or IVF lists and delta
        split, on ``device``."""
        eng = cls(config, device=device)
        eng._vectors = ChunkedArray(
            [np.asarray(state["vectors"], dtype=np.float32)])
        eng._n = int(state["n"][0])
        eng.metadata = MetadataStore.from_state_dict(
            {k[5:]: v for k, v in state.items() if k.startswith("meta.")})
        if "codes" in state:
            codes = np.asarray(state["codes"])
            eng._codes = (bq_mod.from_uint32(codes) if codes.dtype == np.uint32
                          else codes if codes.dtype == np.uint8
                          else codes.astype(np.int32))
        pq_state = {k[3:]: v for k, v in state.items() if k.startswith("pq.")}
        if pq_state:
            eng._pq = pq_mod.ProductQuantizer(dataclasses.replace(
                config.pq, metric="cosine" if config.metric == "cosine"
                else "l2"), device=eng.device)
            eng._pq.load_state_dict(pq_state)
        bq_state = {k[3:]: v for k, v in state.items() if k.startswith("bq.")}
        if bq_state:
            eng._bq = bq_mod.BinaryQuantizer(config.bq, device=eng.device)
            eng._bq.load_state_dict(bq_state)
        sealed_n = int(state["sealed_n"][0]) if "sealed_n" in state else eng._n
        ivf_state = {k[4:]: v for k, v in state.items()
                     if k.startswith("ivf.")}
        if ivf_state:
            # mirror _build_index: PQ probes reconstructions under L2 (the
            # ADC identity), everything else raw vectors under the engine
            # metric
            if config.quantization == "pq":
                eng._ivf = IVFIndex(dataclasses.replace(config.ivf,
                                                        metric="l2"),
                                    device=eng.device)
                eff = eng._pq.decode(eng._codes[:sealed_n])
            else:
                eng._ivf = IVFIndex(config.ivf, device=eng.device)
                eff = eng.vectors[:sealed_n]
            eng._ivf.load_state_dict(ivf_state)
            # lists cover sealed rows only
            eng._ivf_corpus = eng._ivf.prep(eff)
            eng._dirty = False
        hnsw_state = {k[5:]: v for k, v in state.items()
                      if k.startswith("hnsw.")}
        if hnsw_state:
            eff_metric = {"pq": "l2", "bq": "dot"}.get(config.quantization,
                                                       config.metric)
            eng._packed = PackedHNSW.from_state_dict(
                hnsw_state, dataclasses.replace(config.hnsw, metric=eff_metric))
            eng._device_graph = eng._to_device_graph()
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
                tail_codes = (eng._codes[sealed_n:]
                              if eng._codes is not None else None)
                eng._delta.append(eng.vectors[sealed_n:], tail_codes)
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
        if self._ivf is not None and self._ivf.list_sizes is not None:
            sizes = np.asarray(self._ivf.list_sizes)
            out["ivf_lists"] = int(sizes.shape[0])
            out["ivf_mean_list"] = float(sizes.mean())
            out["ivf_max_list"] = int(sizes.max())
        for quantizer in (self._pq, self._bq):
            if quantizer is not None:
                out["compression"] = quantizer.compression_ratio(
                    self.config.dim)
        return out
