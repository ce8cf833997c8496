"""Distribution on ``torch.distributed``: the sharded search, and the
sharding policy of the train step (``ShardingPolicy``,
``make_train_shardings``)."""

from .search import make_flat_search, make_hamming_search, make_pq_search
from .sharding import (Placement, ShardingPolicy, make_train_shardings,
                       placements)
