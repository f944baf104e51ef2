"""Sharding across a single-controller device mesh (port of
:mod:`openfdcm_tpu.parallel`): candidate, scene, template-bank and row
sharding on the port's kernels, each equal to the unsharded call
(:mod:`.mesh` says how a mesh runs)."""
from .mesh import Mesh
from .sharded import (
    make_mesh, pad_to_multiple, optimize_candidates_sharded,
    optimize_candidates_sharded_batch, topk_candidates,
)
from .distributed import initialize, global_topk
from .spatial import RowShardedStack, build_featuremap_spatial, search_spatial
from .bank import match_many_bank_sharded, prepare_bank_shards

__all__ = [
    "make_mesh", "pad_to_multiple", "optimize_candidates_sharded",
    "optimize_candidates_sharded_batch", "topk_candidates",
    "initialize", "global_topk", "build_featuremap_spatial",
    "search_spatial",
    "match_many_bank_sharded", "prepare_bank_shards",
]
