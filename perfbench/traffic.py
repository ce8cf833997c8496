"""The one traffic generator: it reads a mix's parameters
(``workloads/<traffic>.json``) and gives a run's batches in order.

Every mix is a closed loop of one client: the client sends its next batch
when the previous one has returned its ids.  A mix's keys: ``batch``,
queries a batch; ``k``, neighbours a query; ``why``, one line on why the
mix exists.

Batch j takes the queries at positions [j·B, j·B + B) modulo the pool's
size of one seeded permutation of the query pool, so every batch is a
contiguous slice of the permuted pool (taken twice over to wrap) and each
query comes round as often as any other.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .datagen import sub_seed


@dataclass(frozen=True)
class Mix:
    batch: int
    k: int

    @classmethod
    def from_spec(cls, spec: dict) -> "Mix":
        extra = set(spec) - {"batch", "k", "why"}
        if extra:
            raise ValueError(f"traffic: unknown keys {sorted(extra)}")
        mix = cls(batch=int(spec["batch"]), k=int(spec["k"]))
        if mix.batch < 1 or mix.k < 1:
            raise ValueError("traffic: batch and k must be positive")
        return mix


class Schedule:
    """A run's batches: `start(j)`, the first position of batch j in
    `order` (the permuted pool twice over)."""

    def __init__(self, mix: Mix, pool: int, seed: int):
        if mix.batch > pool:
            raise ValueError(f"traffic: batch {mix.batch} > pool {pool}")
        self.mix, self.pool = mix, pool
        g = torch.Generator()
        g.manual_seed(sub_seed(seed, "order"))
        perm = torch.randperm(pool, generator=g)
        self.order = torch.cat([perm, perm])

    def start(self, j: int) -> int:
        return (j * self.mix.batch) % self.pool

    def positions(self, j: int) -> torch.Tensor:
        """Pool indices of batch j's queries."""
        s = self.start(j)
        return self.order[s: s + self.mix.batch]
