"""Row sharding of one scene's DT3 stack across a mesh axis (port of
:mod:`openfdcm_tpu.parallel.spatial`).

A scene whose ``(D, H, W)`` stack does not fit one device is built with
its H axis split into equal row blocks, one on each entry of the mesh axis,
and searched without gathering it.  Each step is bit-equal to the
unsharded build:

- seed scatter, logical mask: each block writes its own rows, with global
  row indices (a seed outside the block is masked, never indexed);
- the EDT column pass, a cumulative min along the split axis: local scans
  combined with carries from the other blocks' aggregates
  (:func:`~openfdcm_tpu_torch.core.dt.column_pass_rows`); min is exact;
- the EDT row pass (kernel K2) and the orientation propagation (kernel K3)
  are row-local: each runs per block;
- the directional line integral, a sum whose order must not change: the
  blocks scan in sweep order, each continuing from the carry of the block
  before it (a wavefront), with the step algebra of the unsharded sweep
  (:func:`~openfdcm_tpu_torch.ops.integral.sweep_scan_plain`); x-major
  sweeps, whose carry runs along the split axis, are re-sliced into column
  blocks for the sweep and back.  As in the JAX package this scan is plain
  torch: kernel K4 takes no carry.

:func:`search_spatial` probes the row blocks where they lie: each window's
probe values come from every block's owned rows, the others masked to 0,
summed in block order (exact), so its scores equal the unsharded
:func:`~openfdcm_tpu_torch.matching.match.search`'s.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import draw
from ..core import geometry as geo
from ..core.dt import column_pass_rows, row_pass
from ..core.integral import sweep_groups
from ..core.types import F32_MAX
from ..matching import featuremap as fm
from ..matching.optimize_kernel import optimize_candidates_batch_kernel
from ..ops.integral import sweep_scan_plain
from .mesh import Mesh

__all__ = ["RowShardedStack", "build_featuremap_spatial", "search_spatial"]


class RowShardedStack:
    """A ``(D, H, W)`` stack held as equal row blocks ``(D, H / n, W)``,
    block ``b`` on the ``b``-th entry of a mesh axis."""

    def __init__(self, blocks):
        self.blocks = list(blocks)

    @property
    def shape(self) -> tuple:
        d, h_loc, w = self.blocks[0].shape
        return (d, h_loc * len(self.blocks), w)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def gather(self, device=None) -> torch.Tensor:
        """The whole stack on ``device`` (default the first block's)."""
        return Mesh.all_gather(self.blocks, device or self.device, dim=1)


class _RowProbe:
    """The probe gather of a one-scene search against a
    :class:`RowShardedStack` (JAX ``spatial._spatial_take``): the values of
    the flat ``(1, D, H, W)`` stack at flat indices clamped into it, each
    read from the block that owns its row and summed over the blocks in
    block order on ``device``.  Stands for the stack in
    :func:`~openfdcm_tpu_torch.matching.optimize_kernel.optimize_candidates_batch_kernel`
    through ``shape`` and ``device``."""

    def __init__(self, stack: RowShardedStack, device):
        self.stack = stack
        self.shape = (1, *stack.shape)
        self.device = device

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        d, ph, pw = self.stack.shape
        h_loc = ph // len(self.stack.blocks)
        vals = []
        for b, blk in enumerate(self.stack.blocks):
            i = idx.to(blk.device).clamp(0, d * ph * pw - 1)
            s = i // (ph * pw)
            rem = i - s * (ph * pw)
            y = rem // pw
            x = rem - y * pw
            owned = (y >= b * h_loc) & (y < (b + 1) * h_loc)
            local = s * (h_loc * pw) + (y - b * h_loc) * pw + x
            v = blk.reshape(-1)[torch.where(owned, local, 0)]
            vals.append(torch.where(owned, v, torch.zeros((), dtype=v.dtype,
                                                          device=v.device)))
        return Mesh.psum(vals, self.device)


def _seed_rows(lines: torch.Tensor, depth: int, logical_hw, y0: int,
               h_loc: int, pw: int, max_points: int) -> torch.Tensor:
    """The seed indicator of rows ``[y0, y0 + h_loc)`` of a scene's
    ``(depth, PH, PW)`` stack: 0.0 at the seed pixels of each line's slice,
    ``F32_MAX`` elsewhere; seeds of other rows are masked out before the
    write."""
    h, w = logical_hw
    slice_of_line = fm.classify_lines(fm.make_angles(depth), lines).to(torch.int64)
    box = torch.tensor([0.0, w - 1.0, 0.0, h - 1.0], dtype=torch.float32,
                       device=lines.device)
    pts, pmask = draw.seed_points_box(lines, box, max_points)       # (N, P, 2)
    x = pts[..., 0].to(torch.int64)
    y = pts[..., 1].to(torch.int64)
    keep = pmask & (y >= y0) & (y < y0 + h_loc) & (x >= 0) & (x < pw)
    flat = slice_of_line[:, None] * (h_loc * pw) + (y - y0) * pw + x
    ind = torch.full((depth * h_loc * pw,), F32_MAX, dtype=torch.float32,
                     device=lines.device)
    ind[flat[keep]] = 0.0
    return ind.reshape(depth, h_loc, pw)


def _line_integral_rows(blocks, angles, logical_hw, ph: int, pw: int,
                        devices) -> list:
    """The directional line integrals of row blocks ``(D, h_loc, PW)``: per
    sweep group the blocks scan in sweep order (reversed for a flipped
    sweep), each from the carry the block before it ended with; x-major
    groups are re-sliced into column blocks for the sweep and back."""
    nblk = len(blocks)
    out = [torch.empty_like(b) for b in blocks]
    for x_major, flip, sel, deltas in sweep_groups(angles, logical_hw, ph, pw):
        grp = [b[torch.as_tensor(sel, device=b.device)] for b in blocks]
        if x_major:         # carry along H: sweep W blocks of full columns
            grp = Mesh.all_to_all(grp, split_dim=2, concat_dim=1, devices=devices)
        n_loc = (pw if x_major else ph) // nblk
        swept = [None] * nblk
        carry = None
        for b in (range(nblk - 1, -1, -1) if flip else range(nblk)):
            dev = devices[b]
            d = torch.as_tensor(np.ascontiguousarray(
                deltas[:, b * n_loc:(b + 1) * n_loc]), device=dev)
            swept[b] = sweep_scan_plain(
                grp[b], d, flip, x_major,
                init=None if carry is None else Mesh.ppermute(carry, dev))
            last = 0 if flip else n_loc - 1
            carry = swept[b][:, :, last] if x_major else swept[b][:, last, :]
        if x_major:
            swept = Mesh.all_to_all(swept, split_dim=1, concat_dim=2,
                                    devices=devices)
        for b in range(nblk):
            out[b][torch.as_tensor(sel, device=out[b].device)] = swept[b]
    return out


def build_featuremap_spatial(scene, params: fm.Dt3Params = fm.Dt3Params(), *,
                             mesh: Mesh, axis: str = "rows",
                             pad_to: int | None = 128) -> fm.Dt3Featuremap:
    """Build one scene's DT3 feature map with its H axis split over
    ``mesh[axis]``: its ``dt3`` is a :class:`RowShardedStack`, block ``b`` on
    the axis's ``b``-th entry; ``angles`` and ``scene_translation`` lie on
    the first entry.  The physical H and W are rounded up to a multiple of
    ``lcm(pad_to, n)``; on the logical region the stack equals
    :func:`~openfdcm_tpu_torch.matching.featuremap.build_featuremap`'s bit
    for bit."""
    mesh.require_local("build_featuremap_spatial")
    devices = mesh.along(axis)
    nblk = len(devices)
    scene = geo.as_lines_np(scene)
    if scene.shape[0] == 0:
        return fm.empty_featuremap(params, device=devices[0])
    translation, (w, h) = fm.scene_centered_translation(scene, params.padding)
    translated = scene + np.concatenate([translation, translation]).astype(np.float32)
    angles = fm.make_angles(params.depth)
    unit = int(np.lcm(int(pad_to) if pad_to else 1, nblk))
    ph, pw = -(-h // unit) * unit, -(-w // unit) * unit
    h_loc = ph // nblk
    span = np.maximum(np.abs(scene[:, 2] - scene[:, 0]),
                      np.abs(scene[:, 3] - scene[:, 1])).max()
    max_points = min(max(ph, pw), -(-(int(span) + 2) // 64) * 64)

    seeds = [_seed_rows(torch.as_tensor(translated, device=dev), params.depth,
                        (h, w), b * h_loc, h_loc, pw, max_points)
             for b, dev in enumerate(devices)]
    steps = fm.propagation_steps(angles, params.dt3_coeff)
    blocks = []
    for b, g in enumerate(column_pass_rows(seeds)):
        dt3 = row_pass(g, metric=params.distance)                      # K2
        ys = torch.arange(b * h_loc, (b + 1) * h_loc, device=dt3.device)
        xs = torch.arange(pw, device=dt3.device)
        inside = (ys[:, None] < h) & (xs[None, :] < w)
        dt3 = torch.where(inside[None], dt3, torch.zeros((), device=dt3.device))
        blocks.append(fm.propagate_orientation_relax(dt3, steps))    # K3
    blocks = _line_integral_rows(blocks, angles, (h, w), ph, pw, devices)
    return fm.Dt3Featuremap(
        dt3=RowShardedStack(blocks),
        angles=torch.as_tensor(angles, device=devices[0]),
        scene_translation=torch.as_tensor(translation, device=devices[0]),
        feature_size=(w, h), params=params)


def search_spatial(searcher, optimizer, featuremap: fm.Dt3Featuremap,
                   templates, scene, *, mesh: Mesh, axis: str = "rows"):
    """:func:`~openfdcm_tpu_torch.matching.match.search` against a feature
    map from :func:`build_featuremap_spatial` on ``mesh[axis]``, the stack
    never gathered: every window reads its probes through the row blocks
    (the JAX package's ``take_fn``), on K1's arithmetic.  ``templates``:
    host line arrays, or a :class:`~openfdcm_tpu_torch.TemplateBank` on the
    feature map's first entry.  Returns an UNSORTED list of matches equal
    to the unsharded ``search``'s."""
    mesh.require_local("search_spatial")
    from ..matching import optimize as opt
    from ..matching.match import (Match, TemplateBank, _bucket,
                                  _scene_candidates, prepare_templates)
    from ..matching.pipeline import _bank_pairs_for_scene
    dev = featuremap.angles.device
    bank = templates if isinstance(templates, TemplateBank) \
        else prepare_templates(templates, device=dev)
    if bank.device != dev:
        raise ValueError(f"template bank on {bank.device}, feature map on {dev}")
    scene_arr = geo.as_lines_np(scene) if np.asarray(scene).size \
        else np.zeros((0, 4), np.float32)
    if not bank.host or scene_arr.shape[0] == 0 \
            or featuremap.feature_size == (0, 0):
        return []
    stack = featuremap.dt3
    if len(stack.blocks) != mesh.axis_size(axis):
        raise ValueError(f"a stack of {len(stack.blocks)} row blocks on a "
                         f"mesh axis of {mesh.axis_size(axis)}")
    pairs = _bank_pairs_for_scene(searcher, bank, scene_arr)
    if pairs.shape[0] == 0:
        return []
    cand_lines, cand_mask, cand_align, transforms, ok = _scene_candidates(
        bank, pairs, scene_arr, _bucket(pairs.shape[0], 64))
    mode, window = opt.optimizer_mode(optimizer)
    w, h = featuremap.feature_size
    probe = _RowProbe(stack, dev)
    scores, translations, valid = optimize_candidates_batch_kernel(
        probe, featuremap.angles, featuremap.scene_translation[None],
        torch.tensor([[float(w), float(h)]], device=dev), cand_lines[None],
        cand_mask[None], cand_align[None], mode=mode, window=max(window, 1),
        dense_steps=opt.dense_step_count(optimizer, max(w, h)),
        cand_ok=ok[None], take=probe)
    mats = transforms.clone()
    mats[..., 2] += translations[0]
    scores, mats, valid = (x.cpu().numpy() for x in (scores[0], mats, valid[0]))
    return [Match(int(pairs[j // 2, 0]), float(scores[j]), mats[j].copy())
            for j in range(2 * pairs.shape[0]) if valid[j]]
