from .spatial import ShardedConfig, dryrun, make_sharded_step, shard_state

__all__ = [
    "ShardedConfig",
    "dryrun",
    "make_sharded_step",
    "shard_state",
]
