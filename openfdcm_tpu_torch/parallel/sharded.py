"""Candidate and scene sharding of the batched optimizer (port of
:mod:`openfdcm_tpu.parallel.sharded`).

- candidate parallelism (axis ``"cand"``): the candidate tensor is split
  across the mesh and every shard walks its own candidates against a
  replicated stack on the port's window kernels (K1, the tile copy);
- scene parallelism (axis ``"scene"``): a batch of stacks is split across
  that axis, and each scene block's candidates across ``"cand"``.

Every shard runs :func:`~openfdcm_tpu_torch.matching.optimize_kernel.optimize_candidates_batch_kernel`
on its device with no traffic between shards (its walks' host syncs stay
local); the only collective is the final gather.  A candidate's result does
not depend on the others, so the sharded call equals the unsharded one.

On a mesh that spans processes (:mod:`.distributed`) every process passes
the same replicated inputs, runs the blocks of its own entries and returns
them as :class:`~.mesh.ShardedTensor` s, with no gather, as the JAX
package's ``shard_map`` leaves its outputs sharded.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import resolve_device
from ..matching.match import _ranking
from ..matching.optimize_kernel import optimize_candidates_batch_kernel
from .distributed import all_gather_tensors, process_index
from .mesh import Mesh, Shard, ShardedTensor

__all__ = [
    "make_mesh", "pad_to_multiple", "optimize_candidates_sharded",
    "optimize_candidates_sharded_batch", "topk_candidates",
]


def make_mesh(shape=None, axis_names=("cand",), devices=None) -> Mesh:
    """A device mesh for candidate (and optionally scene, bank or row)
    parallelism.

    ``devices=None`` takes every visible CUDA device and raises where this
    process has none; once a process group is joined
    (:func:`~.distributed.initialize`), every process's: each rank
    contributes its visible CUDA devices, ranks in order, as
    ``jax.devices()`` orders processes (give a rank one card with
    ``CUDA_VISIBLE_DEVICES``).  An explicit ``devices`` list holds this
    process's devices, and may repeat one: ``[cuda:0] * 4`` tests the
    sharding on one card, ``[cpu] * 8`` on the CPU.  Its global form holds
    ``(process index, device)`` pairs, each entry naming the rank that owns
    it, the same list in every process: ``[(0, cpu)] * 4 + [(1, cpu)] * 4``
    is a mesh over two processes.  ``shape=None`` puts all the devices on
    the first axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "devices=[...] to build a mesh of other devices")
        counts = all_gather_tensors(torch.tensor([torch.cuda.device_count()]))
        devices = [(rank, torch.device("cuda", i))
                   for rank, n in enumerate(counts) for i in range(int(n))]
    me = process_index()
    entries = [d if isinstance(d, tuple) else (me, d) for d in devices]
    if shape is None:
        shape = (len(entries),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(entries):
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got {len(entries)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [resolve_device(d) for _, d in entries[:n]]
    procs = np.asarray([int(p) for p, _ in entries[:n]], dtype=np.int64)
    return Mesh(grid.reshape(tuple(shape)), axis_names,
                processes=procs.reshape(tuple(shape)))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def _own_shards(mesh: Mesh, axes, shapes, block) -> tuple:
    """The outputs of ``block(coords along axes, device)`` for this
    process's entries of a mesh that spans processes, as one
    :class:`~.mesh.ShardedTensor` per output of whole shape ``shapes[i]``,
    split along its leading ``len(axes)`` dimensions and replicated along
    the mesh's other axes (``shard_map``'s ``P(*axes)``).  A block is
    computed once per (block, device)."""
    sizes = [mesh.axis_size(a) for a in axes]
    step = [d // n for d, n in zip(shapes[0], sizes)]
    done, shards = {}, [[] for _ in shapes]
    for coords, dev in mesh.own_entries():
        at = tuple(coords.get(a, 0) for a in axes)
        if (at, dev) not in done:
            done[at, dev] = block(at, dev)
        index = tuple(slice(i * b, (i + 1) * b) for i, b in zip(at, step))
        for out, shape, data in zip(shards, shapes, done[at, dev]):
            out.append(Shard(index + (slice(None),) * (len(shape) - len(at)),
                             data, dev))
    return tuple(ShardedTensor(tuple(shape), out) for shape, out in zip(shapes, shards))


def optimize_candidates_sharded(mesh: Mesh, dt3_flat, angles, scene_tr, hw,
                                feature_size, cand_lines, cand_mask,
                                cand_align, *, mode: str, window: int,
                                dense_steps: int, axis: str = "cand",
                                cand_ok=None):
    """Candidate-sharded optimize of one scene: ``dt3_flat`` the flattened
    ``(D, *hw)`` stack (replicated), ``scene_tr`` / ``feature_size``
    ``(2,)``, ``cand_lines (C, L, 4)``, ``cand_mask (C, L)``, ``cand_align
    (C, 2)`` and the optional ``cand_ok (C,)`` split into ``mesh[axis]``
    equal blocks.  Returns ``(scores (C,), translations (C, 2), valid
    (C,))`` gathered onto ``cand_lines``' device; on a mesh that spans
    processes, this process's blocks as :class:`~.mesh.ShardedTensor` s."""
    n = mesh.axis_size(axis)
    c = cand_mask.shape[0]
    if c % n:
        raise ValueError(f"axis of size {c} does not split into {n} equal blocks")
    cb = c // n
    li = dt3_flat.reshape(1, -1, *hw)

    def block(at, dev):
        cs = slice(at[0] * cb, (at[0] + 1) * cb)
        out = optimize_candidates_batch_kernel(
            li.to(dev), angles.to(dev), scene_tr.to(dev)[None],
            feature_size.to(dev)[None], cand_lines[cs].to(dev)[None],
            cand_mask[cs].to(dev)[None], cand_align[cs].to(dev)[None],
            mode=mode, window=window, dense_steps=dense_steps,
            cand_ok=None if cand_ok is None else cand_ok[cs].to(dev)[None])
        return tuple(x[0] for x in out)

    if not mesh.local:
        return _own_shards(mesh, (axis,), [(c,), (c, 2), (c,)], block)
    parts = [block((j,), dev) for j, dev in enumerate(mesh.along(axis))]
    return tuple(Mesh.all_gather(p, cand_lines.device) for p in zip(*parts))


def optimize_candidates_sharded_batch(mesh: Mesh, dt3_flat, angles, scene_tr,
                                      hw, feature_size, cand_lines, cand_mask,
                                      cand_align, *, mode: str, window: int,
                                      dense_steps: int,
                                      scene_axis: str = "scene",
                                      cand_axis: str = "cand", cand_ok=None):
    """Scene-batched, 2-D sharded optimize: ``dt3_flat (S, D*H*W)``,
    ``scene_tr`` / ``feature_size (S, 2)``, ``cand_lines (S, C, L, 4)``,
    ``cand_mask (S, C, L)``, ``cand_align (S, C, 2)``, optional ``cand_ok
    (S, C)``.  Scenes split along ``scene_axis``, candidates along
    ``cand_axis``.  Returns ``(scores, translations, valid)`` of shape
    ``(S, C, ...)`` gathered onto ``cand_lines``' device; on a mesh that
    spans processes, this process's blocks as
    :class:`~.mesh.ShardedTensor` s (each process reads its
    ``addressable_shards``)."""
    n_sc, n_cand = mesh.axis_size(scene_axis), mesh.axis_size(cand_axis)
    s_count, c = cand_mask.shape[:2]
    if s_count % n_sc or c % n_cand:
        raise ValueError(f"({s_count} scenes, {c} candidates) do not split "
                         f"into a ({n_sc}, {n_cand}) grid of equal blocks")
    sb, cb = s_count // n_sc, c // n_cand
    li = dt3_flat.reshape(s_count, -1, *hw)

    def block(at, dev):
        rs = slice(at[0] * sb, (at[0] + 1) * sb)
        cs = slice(at[1] * cb, (at[1] + 1) * cb)
        return optimize_candidates_batch_kernel(
            li[rs].to(dev), angles.to(dev), scene_tr[rs].to(dev),
            feature_size[rs].to(dev), cand_lines[rs, cs].to(dev),
            cand_mask[rs, cs].to(dev), cand_align[rs, cs].to(dev),
            mode=mode, window=window, dense_steps=dense_steps,
            cand_ok=None if cand_ok is None else cand_ok[rs, cs].to(dev))

    if not mesh.local:
        return _own_shards(mesh, (scene_axis, cand_axis),
                           [(s_count, c), (s_count, c, 2), (s_count, c)], block)
    out_dev = cand_lines.device
    rows_out = []
    for i in range(n_sc):
        parts = [block((i, j), mesh.device(**{scene_axis: i, cand_axis: j}))
                 for j in range(n_cand)]
        rows_out.append(tuple(Mesh.all_gather(p, out_dev, dim=1)
                              for p in zip(*parts)))
    return tuple(Mesh.all_gather(p, out_dev, dim=0) for p in zip(*rows_out))


def topk_candidates(scores, valid, k: int):
    """Deterministic top-k of candidate scores (ascending = best): invalid
    candidates rank last, ties go to the lowest candidate index
    (:func:`~openfdcm_tpu_torch.matching.match._ranking`).  Returns
    ``(scores_k, idx_k)``."""
    masked = torch.where(valid, scores, float("inf"))
    idx = _ranking(masked)[:k]
    return masked[idx], idx
