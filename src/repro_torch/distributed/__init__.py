"""Scale-out helpers of the port: straggler detection and shard
rebalancing (the mesh itself is not ported yet)."""
