"""Quantixar core in PyTorch: the HNSW, flat and IVF engines, unquantized or
with PQ / BQ codes (code-domain HNSW search, exact rescore, the quantized
flat route), the bulk builder, the wide-beam search, the exact scans on the
``l2_distance`` kernel and the BM25 sparse index."""

from .bq import BinaryQuantizer, BQConfig
from .distances import (available_metrics, brute_force_topk, get_metric,
                        normalize, pairwise_cosine, pairwise_dot,
                        pairwise_hamming, pairwise_l2)
from .engine import EngineConfig, QuantixarEngine
from .executor import AnnParams
from .flat import FlatIndex, flat_search, merge_topk, topk_smallest
from .hnsw_build import HNSWConfig, PackedHNSW, build, bulk_build, exact_knn
from .hnsw_bulk import bulk_build_device
from .hnsw_search import HNSWGraph, recall_at_k, search, to_device
from .ivf import IVFConfig, IVFIndex
from .metadata import And, Filter, MetadataStore, Not, Or, Predicate
from .pq import PQConfig, ProductQuantizer
from .segment import DeltaSegment, SealPolicy, merge_candidates
from .sparse import SparseIndex, TokenizerConfig

__all__ = [
    "available_metrics", "brute_force_topk", "get_metric", "normalize",
    "pairwise_cosine", "pairwise_dot", "pairwise_hamming", "pairwise_l2",
    "EngineConfig", "QuantixarEngine",
    "AnnParams", "FlatIndex", "flat_search", "merge_topk", "topk_smallest",
    "HNSWConfig",
    "PackedHNSW", "build", "bulk_build", "exact_knn", "bulk_build_device",
    "HNSWGraph", "recall_at_k", "search", "to_device", "And", "Filter",
    "MetadataStore", "Not", "Or", "Predicate", "DeltaSegment", "SealPolicy",
    "merge_candidates", "PQConfig", "ProductQuantizer", "BQConfig",
    "BinaryQuantizer", "IVFConfig", "IVFIndex", "SparseIndex",
    "TokenizerConfig",
]
