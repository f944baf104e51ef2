"""Sharding across a device mesh (port of :mod:`openfdcm_tpu.parallel`):
candidate, scene, template-bank and row sharding on the port's kernels,
each equal to the unsharded call, under one controller or, for the sharded
optimizers and ``global_topk``, with one process per rank (:mod:`.mesh`
says how a mesh runs, :mod:`.distributed` how processes join one)."""
from .mesh import Mesh, Shard, ShardedTensor
from .sharded import (
    make_mesh, pad_to_multiple, optimize_candidates_sharded,
    optimize_candidates_sharded_batch, topk_candidates,
)
from .distributed import (initialize, global_topk, process_index,
                          process_count, all_gather_tensors)
from .spatial import RowShardedStack, build_featuremap_spatial, search_spatial
from .bank import match_many_bank_sharded, prepare_bank_shards

__all__ = [
    "Mesh", "Shard", "ShardedTensor",
    "make_mesh", "pad_to_multiple", "optimize_candidates_sharded",
    "optimize_candidates_sharded_batch", "topk_candidates",
    "initialize", "global_topk", "process_index", "process_count",
    "all_gather_tensors", "build_featuremap_spatial",
    "search_spatial",
    "match_many_bank_sharded", "prepare_bank_shards",
]
