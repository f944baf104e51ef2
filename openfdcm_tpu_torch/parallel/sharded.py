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
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import resolve_device
from ..matching.optimize_kernel import optimize_candidates_batch_kernel
from .mesh import Mesh

__all__ = [
    "make_mesh", "pad_to_multiple", "optimize_candidates_sharded",
    "optimize_candidates_sharded_batch", "topk_candidates",
]


def make_mesh(shape=None, axis_names=("cand",), devices=None) -> Mesh:
    """A device mesh for candidate (and optionally scene, bank or row)
    parallelism.

    ``devices=None`` takes every visible CUDA device and raises where there
    is none.  An explicit ``devices`` list may repeat one device: ``[cuda:0]
    * 4`` tests the sharding on one card, ``[cpu] * 8`` on the CPU.
    ``shape=None`` puts all the devices on the first axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "devices=[...] to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(tuple(shape)), axis_names)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


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
    (C,))`` gathered onto ``cand_lines``' device."""
    devices = mesh.along(axis)
    li = dt3_flat.reshape(1, -1, *hw)
    blocks = [Mesh.split(x, devices) for x in (cand_lines, cand_mask, cand_align)]
    oks = [None] * len(devices) if cand_ok is None else Mesh.split(cand_ok, devices)
    parts = []
    for dev, lines, mask, align, ok in zip(devices, *blocks, oks):
        out = optimize_candidates_batch_kernel(
            li.to(dev), angles.to(dev), scene_tr.to(dev)[None],
            feature_size.to(dev)[None], lines[None], mask[None], align[None],
            mode=mode, window=window, dense_steps=dense_steps,
            cand_ok=None if ok is None else ok[None])
        parts.append(tuple(x[0] for x in out))
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
    ``(S, C, ...)`` gathered onto ``cand_lines``' device."""
    n_sc, n_cand = mesh.axis_size(scene_axis), mesh.axis_size(cand_axis)
    s_count, c = cand_mask.shape[:2]
    if s_count % n_sc or c % n_cand:
        raise ValueError(f"({s_count} scenes, {c} candidates) do not split "
                         f"into a ({n_sc}, {n_cand}) grid of equal blocks")
    sb, cb = s_count // n_sc, c // n_cand
    li = dt3_flat.reshape(s_count, -1, *hw)
    out_dev = cand_lines.device
    rows_out = []
    for i in range(n_sc):
        rs = slice(i * sb, (i + 1) * sb)
        parts = []
        for j in range(n_cand):
            dev = mesh.device(**{scene_axis: i, cand_axis: j})
            cs = slice(j * cb, (j + 1) * cb)
            parts.append(optimize_candidates_batch_kernel(
                li[rs].to(dev), angles.to(dev), scene_tr[rs].to(dev),
                feature_size[rs].to(dev), cand_lines[rs, cs].to(dev),
                cand_mask[rs, cs].to(dev), cand_align[rs, cs].to(dev),
                mode=mode, window=window, dense_steps=dense_steps,
                cand_ok=None if cand_ok is None else cand_ok[rs, cs].to(dev)))
        rows_out.append(tuple(Mesh.all_gather(p, out_dev, dim=1)
                              for p in zip(*parts)))
    return tuple(Mesh.all_gather(p, out_dev, dim=0) for p in zip(*rows_out))


def topk_candidates(scores, valid, k: int):
    """Deterministic top-k of candidate scores (ascending = best): invalid
    candidates rank last, ties go to the lowest candidate index (a stable
    sort on (score, index), never ``torch.topk``).  Returns ``(scores_k,
    idx_k)``."""
    masked = torch.where(valid, scores, float("inf"))
    idx = torch.sort(masked, stable=True).indices[:k]
    return masked[idx], idx
