from .eval import ShardedEval, make_sharded_eval
from .mesh import Mesh, data_sharding, make_mesh, replicate_sharding, shard_batch
from .tp import combine_shards, tp_nearest_codebook

__all__ = [
    "Mesh", "make_mesh", "data_sharding", "replicate_sharding", "shard_batch",
    "tp_nearest_codebook", "combine_shards", "make_sharded_eval", "ShardedEval",
]
