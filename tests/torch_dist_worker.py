"""The rank function of ``tests/test_torch_distributed.py``: imports only
``torch`` and the port, so spawned ranks never import JAX."""
import json
import sys

import torch
import torch.distributed as dist

from openfdcm_tpu_torch.parallel import initialize


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """Join the group through ``initialize`` (gloo, a ``file://`` init
    method), all-gather each rank's id and write what this rank saw."""
    initialize(f"file://{init_file}", world, rank, backend="gloo")
    try:
        got = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(got, torch.tensor([rank + 1]))
        seen = dict(rank=dist.get_rank(), world=dist.get_world_size(),
                    gathered=[int(t) for t in got],
                    jax=[m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "openfdcm_tpu")])
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(seen, f)
    finally:
        dist.destroy_process_group()
