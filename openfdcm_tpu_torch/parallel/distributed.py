"""Multi-process runtime and the cross-shard top-k (port of
:mod:`openfdcm_tpu.parallel.distributed`).

:func:`initialize` joins a ``torch.distributed`` process group, as the
JAX package's joins the multi-controller runtime.  The sharded paths of
this package run under one controller (:mod:`.mesh`): a mesh that spans
processes is not built on it yet.

:func:`global_topk` is the cross-shard ranking primitive: each shard
reduces its candidates to a local top-k, the small per-shard results are
gathered, and one re-rank by (score, global candidate index) gives a
deterministic global top-k.
"""
from __future__ import annotations

import torch

from .mesh import Mesh
from .sharded import topk_candidates


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl") -> None:
    """Join a ``torch.distributed`` process group: ``coordinator_address``
    an init method (``tcp://host:port``, ``file://path``; a bare
    ``host:port`` is taken as TCP), ``num_processes`` the world size,
    ``process_id`` this process's rank, ``backend`` ``"nccl"`` for the
    cards or ``"gloo"`` for the CPU.  Nothing is read from the
    environment: every argument that ``init_process_group`` needs is
    passed."""
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    torch.distributed.init_process_group(
        backend, init_method=coordinator_address, world_size=num_processes,
        rank=process_id)


def global_topk(mesh: Mesh, scores, valid, k: int, axis: str = "cand"):
    """Deterministic top-k over ``scores (C,)`` / ``valid (C,)`` split into
    ``mesh[axis]`` equal blocks: per block a top-k on its device, the
    blocks' rows gathered onto ``scores``' device, then the ``min(k, n *
    kk)`` best by (score, global index).  Returns ``(scores_k,
    global_idx_k)``, ascending, invalid candidates last."""
    devices = mesh.along(axis)
    c_local = scores.shape[0] // len(devices)
    vals, idxs = [], []
    for b, (s, v) in enumerate(zip(Mesh.split(scores, devices),
                                   Mesh.split(valid, devices))):
        sk, ik = topk_candidates(s, v, min(k, c_local))
        vals.append(sk)
        idxs.append(ik + b * c_local)
    fv = Mesh.all_gather(vals, scores.device)
    fi = Mesh.all_gather(idxs, scores.device)
    by_idx = torch.sort(fi, stable=True).indices
    order = by_idx[torch.sort(fv[by_idx], stable=True).indices][:k]
    return fv[order], fi[order]
