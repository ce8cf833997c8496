"""Distribution on ``torch.distributed``: the sharded search.

The sharding policy of the JAX package's training step
(``ShardingPolicy``, ``make_train_shardings``) belongs to the LM stack's
port and is not here yet."""

from .search import make_flat_search, make_hamming_search, make_pq_search
