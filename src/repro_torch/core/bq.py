"""Binary Quantization (paper §II-B-2) in PyTorch: the port of the JAX
package's ``repro.core.bq``.

  1) Learn `bits` hyperplanes with normals u_1 … u_bits ∈ R^d (data-centred
     blockwise-orthogonal Gaussian normals; an optional PCA rotation).
  2) Encode b_i = 1 if u_iᵀ(x − mean) ≥ 0 else 0.
  3) Search by Hamming distance over the packed codes.

Codes are packed 32 bits a word, bit i at position i % 32 (LSB-first), as in
the JAX package.  torch has no uint32 arithmetic on the CPU, so the port
keeps each word as an int32 holding the same bits; ``state_dict`` gives back
uint32 arrays (`to_uint32`), and `from_uint32` reads them.  The Hamming scan
is the ``hamming`` CUDA kernel on a card (``kernels/ops.py``).

Hyperplanes are drawn from a ``torch.Generator``, so they differ from the
JAX package's ``jax.random`` ones (and the QR's signs from LAPACK's):
parity is held by loading the JAX hyperplanes and mean
(`BinaryQuantizer.load_state_dict`), the port's own training by recall.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .flat import scan_topk

WORD_BITS = 32
# rows per block of encode(): bounds the (rows, bits) projection
ENCODE_CHUNK = 1 << 18


@dataclass(frozen=True)
class BQConfig:
    bits: int = 256            # hyperplanes; multiple of 32 for packing
    center: bool = True        # subtract data mean before projecting
    pca_rotate: bool = False   # beyond-paper: PCA-decorrelate first

    def validate(self) -> None:
        if self.bits % WORD_BITS != 0:
            raise ValueError(
                f"bits={self.bits} must be a multiple of {WORD_BITS}")

    @property
    def words(self) -> int:
        return self.bits // WORD_BITS


def to_uint32(words) -> np.ndarray:
    """int32 words (tensor or array) -> the JAX package's uint32 array."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    return np.ascontiguousarray(words, dtype=np.int32).view(np.uint32)


def from_uint32(words: np.ndarray) -> np.ndarray:
    """uint32 words (the JAX package's) -> int32 words with the same bits."""
    return np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)


def sample_hyperplanes(gen: torch.Generator, d: int, bits: int,
                       device="cpu") -> torch.Tensor:
    """Blockwise-orthogonal Gaussian hyperplane normals (bits, d): each
    block of ≤ d normals is the Q factor of a (d, block) Gaussian (super-bit
    LSH, Ji et al., NeurIPS 2012)."""
    blocks = []
    left = bits
    while left > 0:
        m = min(left, d)
        g = torch.randn((d, m), generator=gen, device=device)
        q, _ = torch.linalg.qr(g)             # reduced: (d, m)
        blocks.append(q.T)
        left -= m
    return torch.cat(blocks, dim=0)


def project_bits(vectors: torch.Tensor, hyperplanes: torch.Tensor,
                 mean: torch.Tensor) -> torch.Tensor:
    """Sign bits (n, bits) int32 ∈ {0, 1}: b_i = [u_iᵀ(x − mean) ≥ 0]."""
    x = vectors.float() - mean[None, :]
    return (x @ hyperplanes.T >= 0.0).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (n, m) {0, 1} -> (n, m/32) int32 words, bit i at i % 32."""
    n, m = bits.shape
    b = bits.reshape(n, m // WORD_BITS, WORD_BITS).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(-1)                 # [0, 2^32) in int64
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_bits(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(n, w) int32 words -> (n, bits) int32 {0, 1}, LSB-first."""
    n, w = packed.shape
    v = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=packed.device)
    b = (v[:, :, None] >> shifts) & 1
    return b.reshape(n, w * WORD_BITS)[:, :bits].to(torch.int32)


def signs(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(n, w) words -> (n, bits) float32 ±1 sign vectors: the float proxy
    whose negated dot product is 2·hamming − bits."""
    return unpack_bits(packed, bits).float() * 2.0 - 1.0


def hamming_distances(q_codes: torch.Tensor,
                      x_codes: torch.Tensor) -> torch.Tensor:
    """(Q, W) × (N, W) words -> (Q, N) int32 Hamming distances (the
    ``hamming`` kernel on a card)."""
    return ops.hamming_distances(q_codes, x_codes)


def hamming_topk(q_codes: torch.Tensor, x_codes: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None,
                 chunk: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest Hamming distances (as float32) of each query,
    ascending, ties to the lowest row, scanning ``chunk`` rows at a time;
    rows where ``mask`` is False score +inf.  Returns (d, int32 ids)."""
    return scan_topk(
        lambda lo, hi: hamming_distances(q_codes, x_codes[lo:hi]).float(),
        x_codes.shape[0], k, chunk=chunk, mask=mask)


def _pca_rotation(x: np.ndarray, bits: int) -> np.ndarray:
    """Top-`bits` principal directions as hyperplane normals (host-side;
    numpy copy of the JAX package's)."""
    xc = x - x.mean(0, keepdims=True)
    cov = xc.T @ xc / max(len(x) - 1, 1)
    w, v = np.linalg.eigh(cov)
    order = np.argsort(w)[::-1]
    v = v[:, order]  # (d, d) descending variance
    d = x.shape[1]
    reps = -(-bits // d)
    normals = np.tile(v.T, (reps, 1))[:bits]
    return normals.astype(np.float32)


class BinaryQuantizer:
    """Stateful wrapper: learn hyperplanes, encode, Hamming search; the
    hyperplanes and mean live on ``device``."""

    def __init__(self, config: BQConfig, device="cuda"):
        config.validate()
        self.config = config
        self.device = resolve_device(device)
        self.hyperplanes: Optional[torch.Tensor] = None
        self.mean: Optional[torch.Tensor] = None

    @property
    def is_trained(self) -> bool:
        return self.hyperplanes is not None

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def train(self, vectors, seed: int = 0) -> None:
        x = self._on_device(vectors).float()
        d = x.shape[1]
        self.mean = x.mean(0) if self.config.center \
            else torch.zeros((d,), device=self.device)
        if self.config.pca_rotate:
            self.hyperplanes = self._on_device(_pca_rotation(
                x.cpu().numpy(), self.config.bits))
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self.hyperplanes = sample_hyperplanes(gen, d, self.config.bits,
                                                  self.device)

    def encode(self, vectors) -> torch.Tensor:
        assert self.is_trained, "train() before encode()"
        x = self._on_device(vectors)
        out = torch.empty((x.shape[0], self.config.words), dtype=torch.int32,
                          device=self.device)
        for lo in range(0, x.shape[0], ENCODE_CHUNK):
            out[lo: lo + ENCODE_CHUNK] = pack_bits(project_bits(
                x[lo: lo + ENCODE_CHUNK], self.hyperplanes, self.mean))
        return out

    def search(self, codes, queries, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return hamming_topk(self.encode(queries), self._on_device(codes), k)

    def compression_ratio(self, d: int, dtype_bytes: int = 4) -> float:
        return (d * dtype_bytes) / (self.config.words * 4)

    # --- persistence in the JAX package's layout ---
    def state_dict(self):
        return {"hyperplanes": self.hyperplanes.cpu().numpy(),
                "mean": self.mean.cpu().numpy()}

    def load_state_dict(self, state):
        self.hyperplanes = self._on_device(
            np.array(state["hyperplanes"], dtype=np.float32))
        self.mean = self._on_device(np.array(state["mean"],
                                               dtype=np.float32))
