"""Synthetic corpora statistically matched to the paper's datasets.

Numpy-only copy of the JAX package's ``repro.data.synthetic``.

The ANN-Benchmark downloads (Fashion-MNIST-784, SIFT-128) are unavailable
offline; these generators reproduce the *structure that matters to the
algorithms under test*:

  * fashion_mnist_like — 784-d, 10 class clusters with shared low-rank
    structure, non-negative pixel-ish range, heavy intra-class correlation —
    what drives HNSW's easy recall on Fashion-MNIST.
  * sift_like — 128-d local-gradient-histogram statistics: non-negative,
    heavy-tailed (exponential magnitudes), block-sparse, L2-comparable —
    the harder, flatter distance distribution of SIFT.
  * gaussian_mixture — generic clustered corpus for quantizer tests.

All generators are deterministic in (seed, shape).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int
    metric: str


FASHION_MNIST = DatasetSpec("fashion-mnist-784", 784, "l2")
SIFT = DatasetSpec("sift-128", 128, "l2")


def gaussian_mixture(n: int, dim: int, n_clusters: int = 32,
                     scale: float = 0.25, seed: int = 0,
                     return_labels: bool = False):
    """Clustered unit-norm-ish corpus — the generic ANN workload."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.randint(0, n_clusters, size=n)
    x = centers[labels] + scale * rng.randn(n, dim).astype(np.float32)
    if return_labels:
        return x.astype(np.float32), labels
    return x.astype(np.float32)


def fashion_mnist_like(n: int, seed: int = 0) -> np.ndarray:
    """784-d, 10 classes, low-rank class templates + pixel noise, clipped ≥ 0."""
    rng = np.random.RandomState(seed)
    rank = 24
    basis = rng.randn(rank, 784).astype(np.float32)
    class_w = rng.randn(10, rank).astype(np.float32) * 2.0
    labels = rng.randint(0, 10, size=n)
    w = class_w[labels] + 0.5 * rng.randn(n, rank).astype(np.float32)
    x = w @ basis + 0.35 * rng.randn(n, 784).astype(np.float32)
    x = np.maximum(x + 1.5, 0.0)                  # pixel-like non-negativity
    return (x * 32.0).astype(np.float32)          # ~[0, 255] range


def sift_like(n: int, seed: int = 0) -> np.ndarray:
    """128-d gradient-histogram statistics: non-negative, heavy-tailed,
    4x4 spatial blocks of 8 orientation bins with within-block correlation."""
    rng = np.random.RandomState(seed)
    # block energies: log-normal per 16 spatial cells
    energy = np.exp(0.8 * rng.randn(n, 16, 1)).astype(np.float32)
    orient = rng.exponential(1.0, size=(n, 16, 8)).astype(np.float32)
    x = (energy * orient).reshape(n, 128)
    # SIFT-style clipping + renorm at 512 scale
    norm = np.linalg.norm(x, axis=1, keepdims=True)
    x = np.minimum(x / np.maximum(norm, 1e-9), 0.2)
    norm2 = np.linalg.norm(x, axis=1, keepdims=True)
    return (512.0 * x / np.maximum(norm2, 1e-9)).astype(np.float32)


def make_corpus(spec: DatasetSpec, n: int, seed: int = 0) -> np.ndarray:
    if spec.name.startswith("fashion"):
        return fashion_mnist_like(n, seed)
    if spec.name.startswith("sift"):
        return sift_like(n, seed)
    return gaussian_mixture(n, spec.dim, seed=seed)


# ---------------------------------------------------------------------------
# LM token streams (architecture training cells)
# ---------------------------------------------------------------------------

def zipf_tokens(rng: np.random.RandomState, shape: Tuple[int, ...],
                vocab: int, alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids in [0, vocab) — realistic rank-frequency."""
    # inverse-CDF sampling on a truncated zipf
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    u = rng.random_sample(shape)
    return np.searchsorted(cdf, u).astype(np.int32)


@dataclasses.dataclass
class TokenBatch:
    tokens: np.ndarray      # (B, S) int32
    targets: np.ndarray     # (B, S) int32 (next-token shifted)
    segment_ids: np.ndarray  # (B, S) int32 (1 = real, 0 = pad)


def lm_batches(vocab: int, batch: int, seq_len: int, seed: int = 0,
               max_vocab_sample: int = 50_000) -> Iterator[TokenBatch]:
    """Infinite deterministic stream of LM batches.

    Sampling cost is kept O(min(vocab, max_vocab_sample)) — huge embedding
    tables don't need every id exercised to train/benchmark.
    """
    rng = np.random.RandomState(seed)
    v = min(vocab, max_vocab_sample)
    while True:
        toks = zipf_tokens(rng, (batch, seq_len + 1), v)
        yield TokenBatch(tokens=toks[:, :-1],
                         targets=toks[:, 1:],
                         segment_ids=np.ones((batch, seq_len), np.int32))
