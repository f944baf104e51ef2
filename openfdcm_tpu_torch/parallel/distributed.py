"""Multi-process runtime and the cross-shard top-k (port of
:mod:`openfdcm_tpu.parallel.distributed`).

:func:`initialize` joins a ``torch.distributed`` process group, as the
JAX package's joins the multi-controller runtime.  Every process then
builds the same global mesh (:func:`~.sharded.make_mesh`, whose entries
name the process that owns them) and makes the same calls, as every
process of a JAX multi-controller job runs the same program:
:func:`~.sharded.optimize_candidates_sharded` and
:func:`~.sharded.optimize_candidates_sharded_batch` run this process's
entries' blocks and return its shards, and :func:`global_topk` gathers
the blocks' top-k across the processes.  ``match_many`` and the other
entry points stay single-controller, as in the JAX package, and raise on
such a mesh.

The process helpers: :func:`process_index`, :func:`process_count`,
:func:`all_gather_tensors` (a small tensor from every process, in rank
order) and :func:`exchange` (point to point, between the owners of a mesh
line).  Under gloo each of them stages its tensors through host memory
explicitly (gloo's CUDA support is not relied on); under nccl they stay
on this process's current card (written for a card per rank, not run
here).  A failed peer or transfer raises.

:func:`global_topk` is the cross-shard ranking primitive: each shard
reduces its candidates to a local top-k, the small per-shard results are
gathered, and one re-rank by (score, global candidate index) gives a
deterministic global top-k.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from .mesh import Mesh

# the dtypes a collective carries, by their code on the wire
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_MAX_DIMS = 8
_HEAD = 2 + _MAX_DIMS          # dtype code, rank, dimensions


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl") -> None:
    """Join a ``torch.distributed`` process group: ``coordinator_address``
    an init method (``tcp://host:port``, ``file://path``; a bare
    ``host:port`` is taken as TCP), ``num_processes`` the world size,
    ``process_id`` this process's rank, ``backend`` ``"nccl"`` for a card
    per rank or ``"gloo"`` for the CPU and for several ranks on one card
    (NCCL refuses two ranks on one GPU).  Nothing is read from the
    environment: every argument that ``init_process_group`` needs is
    passed."""
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    torch.distributed.init_process_group(
        backend, init_method=coordinator_address, world_size=num_processes,
        rank=process_id)


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the process group; 0 without one (JAX
    ``jax.process_index``)."""
    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    """The process group's size; 1 without one (JAX ``jax.process_count``)."""
    return dist.get_world_size() if _joined() else 1


def _staging() -> torch.device:
    """Where the collectives read and write: this process's current card
    under nccl, host memory under every other backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _pack(tensors, staging):
    """``(header, bytes)`` of ``tensors`` on ``staging``: one row of
    ``_HEAD`` int64 per tensor, and their bytes end to end."""
    rows, data = [], []
    for t in tensors:
        if t.dim() > _MAX_DIMS or t.dtype not in _DTYPES:
            raise ValueError(f"a collective carries tensors of at most "
                             f"{_MAX_DIMS} dimensions of {_DTYPES}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        rows.append([_DTYPES.index(t.dtype), t.dim(), *t.shape,
                     *[0] * (_MAX_DIMS - t.dim())])
        data.append(t.detach().to(staging).contiguous().reshape(-1).view(torch.uint8))
    head = torch.tensor(rows, dtype=torch.int64).reshape(-1).to(staging)
    body = torch.cat(data) if data else torch.empty(0, dtype=torch.uint8,
                                                     device=staging)
    return head, body


def _nbytes(row) -> int:
    """The bytes of the tensor one header row describes."""
    code, ndim, *dims = row
    return torch.Size(dims[:ndim]).numel() * _DTYPES[code].itemsize


def _unpack(head, body) -> list:
    """The tensors of one :func:`_pack`, on ``body``'s device."""
    out, at = [], 0
    for row in head.reshape(-1, _HEAD).tolist():
        n = _nbytes(row)
        out.append(body[at:at + n].clone().view(_DTYPES[row[0]])
                   .reshape(row[2:2 + row[1]]))
        at += n
    return out


def _swap(sends: dict, recvs: dict) -> None:
    """Every ``sends[peer]`` to its peer and every ``recvs[peer]`` filled
    from its peer, in one batch (so that nccl pairs them up too); empty
    buffers are skipped on both sides."""
    ops = ([dist.P2POp(dist.isend, t, p) for p, t in sends.items() if t.numel()]
           + [dist.P2POp(dist.irecv, t, p) for p, t in recvs.items() if t.numel()])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def exchange(sends: dict) -> dict:
    """Point-to-point exchange with the peers named in ``sends`` (peer rank
    -> the tensors this process sends it, a list that may be empty): the
    result maps each peer to the tensors it sent this process, on the
    staging device (host memory under gloo).  Every peer makes the matching
    call, with this process among its keys; calls pair up in the order
    they are made."""
    staging, me = _staging(), process_index()
    if me in sends:
        raise ValueError(f"process {me} cannot exchange with itself")
    packed = {p: _pack(ts, staging) for p, ts in sends.items()}
    sizes = {p: torch.empty(2, dtype=torch.int64, device=staging) for p in sends}
    _swap({p: torch.tensor([h.numel(), b.numel()], dtype=torch.int64).to(staging)
           for p, (h, b) in packed.items()}, sizes)
    heads = {p: torch.empty(int(s[0]), dtype=torch.int64, device=staging)
             for p, s in sizes.items()}
    bodies = {p: torch.empty(int(s[1]), dtype=torch.uint8, device=staging)
              for p, s in sizes.items()}
    _swap({p: h for p, (h, _) in packed.items()}, heads)
    _swap({p: b for p, (_, b) in packed.items()}, bodies)
    return {p: _unpack(heads[p], bodies[p]) for p in sends}


def all_gather_tensors(t: torch.Tensor) -> list:
    """``t`` of every process, in rank order, on ``t``'s device (shapes
    may differ; exchanged point to point, so through host memory under
    gloo).  Every process makes the call; without a process group:
    ``[t]``."""
    me, n = process_index(), process_count()
    got = exchange({q: [t] for q in range(n) if q != me}) if n > 1 else {}
    return [t if q == me else got[q][0].to(t.device) for q in range(n)]


def global_topk(mesh: Mesh, scores, valid, k: int, axis: str = "cand"):
    """Deterministic top-k over ``scores (C,)`` / ``valid (C,)`` split into
    ``mesh[axis]`` equal blocks: per block a top-k on its entry's device,
    the blocks' rows gathered onto ``scores``' device in mesh order, then
    the ``min(k, n * kk)`` best by (score, global index).  Returns
    ``(scores_k, global_idx_k)``, ascending, invalid candidates last.

    On a mesh that spans processes every process passes the same
    (replicated) ``scores`` and ``valid``; each computes the blocks of its
    own entries, the owners of a line along ``axis`` exchange them, and
    every process gets the same result (the JAX package's replicated
    output).  A process takes part in every line that holds one of its
    entries, in mesh order."""
    from ..matching.match import _ranking
    from .sharded import topk_candidates    # sharded imports mesh, mesh this module
    n = mesh.axis_size(axis)
    if scores.shape[0] % n:
        raise ValueError(f"{scores.shape[0]} candidates do not split into "
                         f"{n} equal blocks")
    c_local = scores.shape[0] // n
    me = process_index()

    def line(coords):
        owners = mesh.owners(axis, **coords)
        vals, idxs = [], []
        for b, (dev, owner) in enumerate(zip(mesh.along(axis, **coords), owners)):
            if owner != me:
                vals.append(None)
                idxs.append(None)
                continue
            rows = slice(b * c_local, (b + 1) * c_local)
            sk, ik = topk_candidates(scores[rows].to(dev), valid[rows].to(dev),
                                     min(k, c_local))
            vals.append(sk)
            idxs.append(ik + b * c_local)
        fv = mesh.all_gather(vals, scores.device, owners=owners)
        fi = mesh.all_gather(idxs, scores.device, owners=owners)
        order = _ranking(fv, fi)[:k]
        return fv[order], fi[order]

    lines = []
    for coords, _ in mesh.own_entries():
        coords.pop(axis, None)
        if coords not in lines:
            lines.append(coords)
    if not lines:
        raise ValueError(f"process {me} owns no entry of {mesh}")
    results = [line(c) for c in (lines[:1] if mesh.local else lines)]
    return results[0]
