"""The rank functions of ``tests/test_torch_distributed.py`` and
``tests/test_torch_multiprocess.py``: they import only ``torch``, numpy and
the port, so spawned ranks never import JAX."""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from openfdcm_tpu_torch.parallel import initialize


def _jax_modules():
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "openfdcm_tpu")]


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """Join the group through ``initialize`` (gloo, a ``file://`` init
    method), all-gather each rank's id and write what this rank saw."""
    initialize(f"file://{init_file}", world, rank, backend="gloo")
    try:
        got = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(got, torch.tensor([rank + 1]))
        seen = dict(rank=dist.get_rank(), world=dist.get_world_size(),
                    gathered=[int(t) for t in got], jax=_jax_modules())
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(seen, f)
    finally:
        dist.destroy_process_group()


def _shards(sharded) -> list:
    """A :class:`ShardedTensor`'s shards as ``(index, data, device)`` with
    the index as ``[start, stop]`` pairs."""
    return [([[s.start, s.stop] for s in sh.index], sh.data, str(sh.device))
            for sh in sharded.addressable_shards]


def run_mesh(rank: int, world: int, init_file: str, problem: str,
             out_dir: str) -> None:
    """One rank of a mesh over ``world`` processes, each with 4 ``cpu``
    entries: the sharded optimizers on the problem of ``problem`` (an
    ``.npz``) under a ``(scene 2, cand 4)`` and a ``cand 8`` mesh,
    ``global_topk`` on the ``cand 8`` mesh, the mesh collectives along its
    line, the global device list, ``match_many``'s refusal; then rank 1
    leaves without a word and rank 0 records how its next collective
    fails.  Writes ``rank<r>.pt``."""
    from openfdcm_tpu_torch import Dt3Params, DefaultSearch, BatchOptimize, match_many
    from openfdcm_tpu_torch.parallel import (
        Mesh, all_gather_tensors, global_topk, make_mesh,
        optimize_candidates_sharded, optimize_candidates_sharded_batch,
        process_count, process_index)

    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world, rank, backend="gloo")
    cpu = torch.device("cpu")
    p = {k: torch.as_tensor(v) for k, v in np.load(problem).items()}
    entries = [(r, cpu) for r in range(world) for _ in range(4)]
    mesh2 = make_mesh((2, 4), ("scene", "cand"), devices=entries)
    mesh8 = make_mesh((8,), ("cand",), devices=entries)
    hw = tuple(p["hw"].tolist())
    args = (p["dt3_flat"], p["angles"], p["tr"], hw, p["fs"], p["lines"],
            p["mask"], p["av"])
    out = dict(rank=process_index(), world=process_count(), local2=mesh2.local)
    for mode in ("batch", "default"):
        res = optimize_candidates_sharded_batch(mesh2, *args, mode=mode,
                                                window=10, dense_steps=1)
        out[f"batch_{mode}"] = [(r.shape, _shards(r)) for r in res]
    res = optimize_candidates_sharded(
        mesh8, p["dt3_flat"][0], p["angles"], p["tr"][0], hw, p["fs"][0],
        p["lines"][0], p["mask"][0], p["av"][0], mode="batch", window=10,
        dense_steps=1)
    out["cand8"] = [(r.shape, _shards(r)) for r in res]
    for case in ("real", "tie"):
        out[f"topk_{case}"] = global_topk(mesh8, p[f"{case}_scores"],
                                          p[f"{case}_valid"], int(p["k"]))

    # the collectives along mesh8's line (4 parts a process)
    owners = mesh8.owners("cand")
    parts = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * i
             for i in range(8)]
    mine = [x if o == rank else None for x, o in zip(parts, owners)]
    blocks = [torch.arange(16, dtype=torch.int32).reshape(8, 2) + 100 * i
              for i in range(8)]
    a2a = Mesh.all_to_all([b if o == rank else None for b, o in zip(blocks, owners)],
                          0, 1, mesh8.along("cand"), owners=owners)
    carry = torch.tensor([[1.5, -2.0], [3.0, 7.25]])
    out["collectives"] = dict(
        all_gather=Mesh.all_gather(mine, cpu, dim=1, owners=owners),
        psum=Mesh.psum(mine, cpu, owners=owners),
        all_to_all=a2a,
        ppermute=Mesh.ppermute(carry if rank == 0 else None, cpu,
                               owners=(0, world - 1)),
        bools=Mesh.all_gather([torch.tensor([True, False]) if o == rank else None
                               for o in owners], cpu, owners=owners),
        ranks=all_gather_tensors(torch.full((rank + 1, 2), rank)))

    # the global device list of devices=None, each rank "seeing" rank + 1 cards
    real = torch.cuda.is_available, torch.cuda.device_count
    torch.cuda.is_available, torch.cuda.device_count = (lambda: True,
                                                        lambda: rank + 1)
    try:
        glob = make_mesh(axis_names=("cand",))
        out["global"] = ([str(d) for d in glob.devices.reshape(-1)],
                         glob.processes.reshape(-1).tolist())
    finally:
        torch.cuda.is_available, torch.cuda.device_count = real

    try:
        match_many([p["lines"][0, 0].numpy()], [p["lines"][0, 0].numpy()],
                   Dt3Params(4, 5.0, 2.2), DefaultSearch(4, 10),
                   BatchOptimize(10), top_k=2, mesh=mesh2, device="cpu")
        out["match_many"] = "no error"
    except ValueError as e:
        out["match_many"] = str(e)
    out["jax"] = _jax_modules()

    # a rank that dies: rank 1 leaves; rank 0's next collective must raise
    mine_path = os.path.join(out_dir, f"rank{rank}.pt")
    if rank != 0:
        torch.save(out, mine_path)
        os._exit(0)
    try:
        global_topk(mesh8, p["real_scores"], p["real_valid"], int(p["k"]))
        out["dead_peer"] = "no error"
    except RuntimeError as e:
        out["dead_peer"] = f"{type(e).__name__}: {e}"
    torch.save(out, mine_path)
    os._exit(0)
