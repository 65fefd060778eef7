"""Scale-out of the port: the spike mesh (one controller over a grid of
devices), its partition rules, straggler detection and shard
rebalancing."""
