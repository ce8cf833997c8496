"""quantixar-db — the paper's own workload as a dry-runnable config:
a sharded vector corpus searched with flat / PQ-ADC / BQ-hamming scans +
cross-shard top-k merge.  Corpus rows are sharded over (pod, data); the
search step is repro_torch.distributed.search, every rank of the mesh
scanning its own block."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class DBConfig:
    name: str = "quantixar-db"
    n_vectors: int = 100_000_000     # 100M corpus (production cell)
    dim: int = 128                   # SIFT-like
    query_batch: int = 1024
    k: int = 100
    metric: str = "cosine"
    pq_m: int = 16
    pq_k: int = 256
    bq_bits: int = 256


CONFIG = DBConfig()
SMOKE = DBConfig(n_vectors=4096, query_batch=16, k=10)
