"""The benchmark's inputs, made on the device from ``--seed``.

Every array comes from a ``torch.Generator`` of its own, seeded from the
run's seed and the array's name (`sub_seed`), in a few large calls, so the
same seed gives the same inputs whatever else the run makes, and any whole
number is a seed.  The program receives these arrays; the reference makes
them again from the seed once the window has closed.

Corpora (a configuration's ``corpus``; its ``rows``, ``dim`` and the
``queries`` of the pool):

- ``sift_like``: 128-d local-gradient-histogram statistics (non-negative,
  heavy-tailed, 4x4 blocks of 8 orientation bins, clipped at 0.2 and scaled
  to norm 512), the arithmetic of ``repro_torch.data.synthetic.sift_like``
  on the device: ann-benchmarks' sift-128-euclidean's shape.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of the run seeded ``seed``."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, name))
    return g


def sift_like(n: int, g: torch.Generator, device) -> torch.Tensor:
    energy = torch.exp(0.8 * torch.randn((n, 16, 1), generator=g,
                                         device=device))
    x = torch.empty((n, 16, 8), device=device).exponential_(1.0, generator=g)
    x = (x * energy).reshape(n, 128)
    x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-9)
    x = x.clamp_max_(0.2)
    return x.mul_(512.0 / x.norm(dim=1, keepdim=True).clamp_min(1e-9))


def rows(kind: str, n: int, dim: int, g: torch.Generator,
         device) -> torch.Tensor:
    if kind == "sift_like":
        if dim != 128:
            raise ValueError("sift_like rows are 128-d")
        return sift_like(n, g, device)
    raise ValueError(f"unknown corpus kind {kind!r}")


def corpus(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's corpus: ``rows`` rows of ``dim``."""
    return rows(cfg["corpus"], int(cfg["rows"]), int(cfg["dim"]),
                generator(seed, "corpus", device), device)


def query_pool(cfg: dict, seed: int, device) -> torch.Tensor:
    """The pool of queries the traffic draws its batches from."""
    return rows(cfg["corpus"], int(cfg["queries"]), int(cfg["dim"]),
                generator(seed, "queries", device), device)
