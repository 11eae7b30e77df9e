"""Serving-tier sharding: deterministic stream placement across device
pools.

Port of ``repro/sharding``.  It exports what the sharded serving tier
uses: the placement policy that ``serving.shard.ShardedStreamServer``
consults when a new stream needs a pool.  The tier shards *streams*
across per-device slot pools and never moves tensors between devices.
"""

from repro_torch.sharding.placement import (STRATEGIES, PlacementConfig,
                                            PlacementPolicy, PoolLoad)

__all__ = ["PlacementConfig", "PlacementPolicy", "PoolLoad", "STRATEGIES"]
