"""Largest over mean of the shards' drain seconds over the window
(``ShardedDPAStore.shard_drain_ns``)."""


def read(rec):
    d = rec["shard_drain_ns"]
    if d is None or d.size == 0 or d.mean() <= 0:
        return None
    return float(d.max() / d.mean())
