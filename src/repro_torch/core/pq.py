"""Product Quantization (paper §II-B-2) in PyTorch: the port of the JAX
package's ``repro.core.pq``.

  1) Partition x ∈ R^d into m sub-vectors, each in R^{d/m}.
  2) Learn a k-centroid codebook per sub-space (Lloyd's k-means).
  3) Encode each sub-vector as its nearest centroid id (uint8 for k ≤ 256).
  4) Search with Asymmetric Distance Computation (ADC): a (m, k) table of
     query-subvector → centroid squared distances per query; the distance to
     a code is the sum of its m table entries.

The ADC scan is the ``pq_adc`` CUDA kernel on a card (``kernels/ops.py``);
the flat route scans the codes in chunks with the tie-stable top-k, so no
(Q, N) matrix is ever whole.  Cosine: vectors are unit-normalized before
training and encoding, so squared-L2 ADC is monotone in cosine distance.

k-means seeds from a ``torch.Generator``, so trained codebooks differ from
the JAX package's ``jax.random`` ones: parity is held by loading the JAX
codebooks (`ProductQuantizer.load_state_dict`), and the port's own training
is held to quantization error and recall.  The bulk builder's coarse
clustering uses the same single-sub-space k-means (`_fit_one_subspace`).

Codes are uint8 for k ≤ 256 as in the JAX package; for k > 256 the port
keeps int32 (torch has no uint16 arithmetic), and ``state_dict`` layouts
hold uint16 as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .distances import normalize
from .flat import scan_topk

# rows per block of encode(): bounds the (rows, k) distance block
ENCODE_CHUNK = 1 << 18


@dataclass(frozen=True)
class PQConfig:
    m: int = 16          # number of sub-vectors
    k: int = 256         # codebook size per sub-space (uint8 codes)
    iters: int = 25      # Lloyd iterations
    metric: str = "l2"   # "l2" | "cosine"  (cosine == l2 on normalized inputs)

    def validate(self, d: int) -> None:
        if d % self.m != 0:
            raise ValueError(f"d={d} not divisible by m={self.m}")
        if self.k > 65536:
            raise ValueError("k > 65536 unsupported")


# ---------------------------------------------------------------------------
# k-means (one sub-space), run sub-space by sub-space below
# ---------------------------------------------------------------------------

def _kmeans_plus_plus_ish_init(gen: torch.Generator, x: torch.Tensor,
                               k: int) -> torch.Tensor:
    """Cheap seeding: k random distinct samples (with replacement if n < k)."""
    n = x.shape[0]
    if n < k:
        idx = torch.randint(n, (k,), generator=gen, device=x.device)
    else:
        idx = torch.randperm(n, generator=gen, device=x.device)[:k]
    return x[idx]


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, s) × (k, s) -> (n, k) squared L2 in the JAX package's form
    (‖x‖² + ‖c‖² − 2·x·c), so argmins tie-break on the same floats."""
    return ((x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]
            - 2.0 * (x @ c.T))


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration. x: (n, s), centroids: (k, s) -> (new, assign)."""
    assign = _sq_dists(x, centroids).argmin(1)
    k = centroids.shape[0]
    # one-hot product rather than index_add_: a fixed summation order, so
    # the same generator state gives the same centroids run after run; the
    # (n, k) one-hot is built in x's dtype (4 bytes an entry, not int64)
    one_hot = torch.zeros((x.shape[0], k), dtype=x.dtype, device=x.device)
    one_hot.scatter_(1, assign[:, None], 1.0)
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


def train_codebooks(gen: torch.Generator, vectors: torch.Tensor, m: int,
                    k: int, iters: int = 25,
                    normalize_inputs: bool = False) -> torch.Tensor:
    """Learn (m, k, d/m) codebooks, one sub-space after the other: the peak
    is one sub-space's (n, k) distances and one-hot (2 GB at n = 1M,
    k = 256), not m of them."""
    x = normalize(vectors) if normalize_inputs else vectors.float()
    s = x.shape[1] // m
    return torch.stack([
        _fit_one_subspace(gen, x[:, i * s:(i + 1) * s].contiguous(), k, iters)
        for i in range(m)])


def encode(vectors: torch.Tensor, codebooks: torch.Tensor,
           normalize_inputs: bool = False) -> torch.Tensor:
    """Quantize: (n, d) -> (n, m) codes (argmin centroid per sub-space),
    uint8 for k ≤ 256, else int32."""
    x = normalize(vectors) if normalize_inputs else vectors.float()
    m, k, s = codebooks.shape
    n = x.shape[0]
    codes = torch.empty((n, m), dtype=torch.uint8 if k <= 256 else torch.int32,
                        device=x.device)
    for lo in range(0, n, ENCODE_CHUNK):
        blk = x[lo: lo + ENCODE_CHUNK]
        for i in range(m):
            d = _sq_dists(blk[:, i * s:(i + 1) * s], codebooks[i])
            codes[lo: lo + ENCODE_CHUNK, i] = d.argmin(1).to(codes.dtype)
    return codes


def decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstruct (n, d) float32 vectors from (n, m) codes."""
    c = codes.long()
    return torch.cat([codebooks[i][c[:, i]]
                      for i in range(codebooks.shape[0])], dim=1)


def build_adc_lut(queries: torch.Tensor, codebooks: torch.Tensor,
                  normalize_inputs: bool = False) -> torch.Tensor:
    """Per-query lookup tables: (Q, m, k) squared L2 from each query
    sub-vector to every centroid.  ADC(code) = Σᵢ LUT[q, i, code[i]]."""
    q = normalize(queries) if normalize_inputs else queries.float()
    m, k, s = codebooks.shape
    q = q.reshape(q.shape[0], m, s)
    qq = (q * q).sum(-1)                                   # (Q, m)
    cc = (codebooks * codebooks).sum(-1)                   # (m, k)
    qc = torch.bmm(q.transpose(0, 1), codebooks.transpose(1, 2))  # (m, Q, k)
    return (qq[:, :, None] + cc[None] - 2.0 * qc.transpose(0, 1)).contiguous()


def adc_distances(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scan: lut (Q, m, k) × codes (N, m) -> (Q, N) distances (the
    ``pq_adc`` kernel on a card)."""
    return ops.pq_adc_distances(lut, codes)


def adc_topk(lut: torch.Tensor, codes: torch.Tensor, k: int,
             mask: Optional[torch.Tensor] = None,
             chunk: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest ADC distances of each query, ascending, ties to the
    lowest row, scanning ``chunk`` code rows at a time (None: all at once);
    rows where ``mask`` is False score +inf.  Returns (d, int32 ids)."""
    return scan_topk(lambda lo, hi: adc_distances(lut, codes[lo:hi]),
                     codes.shape[0], k, chunk=chunk, mask=mask)


class ProductQuantizer:
    """Stateful wrapper (engine-facing); codebooks live on ``device``."""

    def __init__(self, config: PQConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.codebooks: Optional[torch.Tensor] = None

    @property
    def is_trained(self) -> bool:
        return self.codebooks is not None

    def _norm(self) -> bool:
        return self.config.metric == "cosine"

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def train(self, vectors, seed: int = 0) -> None:
        x = self._on_device(vectors)
        self.config.validate(x.shape[1])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.codebooks = train_codebooks(
            gen, x, self.config.m, self.config.k, iters=self.config.iters,
            normalize_inputs=self._norm())

    def encode(self, vectors) -> torch.Tensor:
        assert self.is_trained, "train() before encode()"
        return encode(self._on_device(vectors), self.codebooks,
                      normalize_inputs=self._norm())

    def decode(self, codes) -> torch.Tensor:
        return decode(self._on_device(codes), self.codebooks)

    def lut(self, queries) -> torch.Tensor:
        return build_adc_lut(self._on_device(queries), self.codebooks,
                             normalize_inputs=self._norm())

    def search(self, codes, queries, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return adc_topk(self.lut(queries), self._on_device(codes), k)

    def compression_ratio(self, d: int, dtype_bytes: int = 4) -> float:
        code_bytes = self.config.m * (1 if self.config.k <= 256 else 2)
        return (d * dtype_bytes) / code_bytes

    # --- persistence in the JAX package's layout ---
    def state_dict(self):
        return {"codebooks": self.codebooks.cpu().numpy()}

    def load_state_dict(self, state):
        self.codebooks = self._on_device(
            np.array(state["codebooks"], dtype=np.float32))
