"""k-means for the bulk build's coarse clustering (paper §II-B-2's Lloyd
iterations), in PyTorch on a ``torch.Generator``.

This slice carries only the single-subspace k-means of the JAX package's
``repro.core.pq`` (``_kmeans_plus_plus_ish_init``, ``_lloyd_step``,
``_fit_one_subspace``), which ``hnsw_bulk`` uses to cluster the corpus.  The
seeding draws from a torch generator, so centroids differ from the JAX
package's ``jax.random`` ones: graphs built through k-means are held to
recall, not to identity.  ``ProductQuantizer`` comes with the PQ slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _kmeans_plus_plus_ish_init(gen: torch.Generator, x: torch.Tensor,
                               k: int) -> torch.Tensor:
    """Cheap seeding: k random distinct samples (with replacement if n < k)."""
    n = x.shape[0]
    if n < k:
        idx = torch.randint(n, (k,), generator=gen, device=x.device)
    else:
        idx = torch.randperm(n, generator=gen, device=x.device)[:k]
    return x[idx]


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration. x: (n, s), centroids: (k, s) -> (new, assign)."""
    xx = (x * x).sum(1)
    cc = (centroids * centroids).sum(1)
    d = xx[:, None] + cc[None, :] - 2.0 * (x @ centroids.T)
    assign = d.argmin(1)
    k = centroids.shape[0]
    # one-hot product rather than index_add_: a fixed summation order, so
    # the same generator state gives the same centroids run after run
    one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)   # (n, k)
    counts = one_hot.sum(0)
    new = (one_hot.T @ x) / counts.clamp_min(1.0)[:, None]
    # empty clusters keep their old centroid (standard fallback)
    new = torch.where(counts[:, None] > 0, new, centroids)
    return new, assign


def _fit_one_subspace(gen: torch.Generator, x: torch.Tensor, k: int,
                      iters: int) -> torch.Tensor:
    cent = _kmeans_plus_plus_ish_init(gen, x, k)
    for _ in range(iters):
        cent, _ = _lloyd_step(x, cent)
    return cent
