"""IVF (inverted-file) index configuration.

Only `IVFConfig` is carried across from the JAX package's
``repro.core.ivf``, unchanged: the collection schema serializes it and the
engine config holds it, so the two packages' schemas and checkpoints agree.
The index itself (`IVFIndex`: k-means coarse quantizer, padded inverted
lists, probing) is not ported yet (ROADMAP A8), and ``index="ivf"`` raises.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    nlist: int = 64           # coarse centroids
    nprobe: int = 8           # lists probed per query
    metric: str = "cosine"    # cosine (normalize + dot) | l2
    kmeans_iters: int = 20
    list_slack: float = 1.5   # max_list = slack * N/nlist (overflow drops
    #                           to the next-nearest list, never silently)
