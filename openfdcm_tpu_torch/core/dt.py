"""Exact distance transforms of seed images (port of :mod:`openfdcm_tpu.core.dt`).

Separable and exact, as in the JAX package:

1. column pass — ``g[y, x] = min_y' |y - y'|`` over seed rows of column x,
   with the cumulative-min identity (``torch.cummin``): :func:`_nearest_1d_l1`
   on the CPU, in one CUDA launch on the card
   (:mod:`openfdcm_tpu_torch.ops.columns`, bit-equal to it);
2. row pass — L1 by the same identity; L2² as the min-plus convolution
   ``min_s (g[r, s]² + (x - s)²)`` and L2 as its square root, both on
   kernel K2 (:mod:`openfdcm_tpu_torch.ops.minplus`), which takes ``g``
   directly and applies the clamp and square root itself.

Every intermediate is an integer below 2^24 or ``F32_MAX``/``inf``, so all
results are exact.  An empty seed set gives ``F32_MAX`` everywhere
(``imgproc.h:174``).

:func:`distance_transform` is the reference's single-image
``distanceTransform`` (``imgproc.h:169-194``) on this machinery: the scene
batch's DT3 build runs the same passes on its whole stack.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.columns import column_pass
from ..ops.minplus import minplus_rows
from . import draw
from . import geometry as geo
from .types import Distance, F32_MAX, resolve_device


def _nearest_1d_l1(f: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``out[..., i] = min_j (f[..., j] + |i - j|)`` along ``dim``."""
    n = f.shape[dim]
    shape = [1] * f.ndim
    shape[dim] = n
    i = torch.arange(n, dtype=torch.float32, device=f.device).reshape(shape)
    fwd = i + torch.cummin(f - i, dim=dim).values
    bwd = torch.flip(torch.cummin(torch.flip(f + i, (dim,)), dim=dim).values,
                     (dim,))
    return torch.minimum(fwd, -i + bwd)


def column_pass_rows(blocks) -> list:
    """:func:`_nearest_1d_l1` along H (``dim=-2``) of a stack split into row
    blocks ``blocks[b] (..., h_b, W)``, each on its own device (JAX
    ``parallel.spatial._column_pass_sharded``): per block the forward and
    backward cumulative minima over its own rows, combined with carries,
    the minimum of the earlier (later) blocks' last (first) rows, gathered
    onto the block's device.  Every value is an integer or ``F32_MAX``, and
    min is exact, so each block equals its rows of the unsharded pass."""
    ys, fwd, bwd = [], [], []
    y0 = 0
    for blk in blocks:
        n = blk.shape[-2]
        y = torch.arange(y0, y0 + n, dtype=torch.float32,
                         device=blk.device).reshape(n, 1)
        ys.append(y)
        fwd.append(torch.cummin(blk - y, dim=-2).values)
        bwd.append(torch.flip(torch.cummin(torch.flip(blk + y, (-2,)),
                                           dim=-2).values, (-2,)))
        y0 += n
    out = []
    for b, (blk, y) in enumerate(zip(blocks, ys)):
        f, r = fwd[b], bwd[b]
        if b > 0:
            f = torch.minimum(f, torch.stack(
                [x[..., -1:, :].to(blk.device) for x in fwd[:b]]).amin(0))
        if b + 1 < len(blocks):
            r = torch.minimum(r, torch.stack(
                [x[..., :1, :].to(blk.device) for x in bwd[b + 1:]]).amin(0))
        out.append(torch.minimum(y + f, -y + r))
    return out


def row_pass(g: torch.Tensor, *, metric: Distance) -> torch.Tensor:
    """Horizontal combine of the column-pass distances ``g (..., H, W)``."""
    if metric == Distance.L1:
        return torch.clamp_max(_nearest_1d_l1(g), F32_MAX)
    return minplus_rows(g, sqrt=metric == Distance.L2)


def dt_from_indicator(ind: torch.Tensor, *, metric: Distance) -> torch.Tensor:
    """Exact DT of a seed-indicator image ``(..., H, W)``: 0 at seed pixels,
    ``F32_MAX`` elsewhere; ``ind`` is left as it was."""
    return row_pass(column_pass(ind), metric=metric)


def indicator_from_points(points: torch.Tensor, mask: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """Seed-indicator image ``(height, width)`` from integer seed pixels
    ``points (S, 2)`` ``(x, y)`` with validity ``mask (S,)``, on their
    device: 0.0 at each valid seed, ``F32_MAX`` elsewhere.  Seeds land as
    the JAX package's drop-mode scatter places them: invalid seeds are
    dropped, indices in ``[-size, -1]`` wrap and the other out-of-range ones
    are dropped.  The mask is applied before the write: an out-of-range
    index on the card is a device assert."""
    x = points[..., 0].reshape(-1).to(torch.int64)
    y = points[..., 1].reshape(-1).to(torch.int64)
    keep = (mask.reshape(-1) & (x >= -width) & (x < width)
            & (y >= -height) & (y < height))
    ind = torch.full((height, width), F32_MAX, dtype=torch.float32,
                     device=points.device)
    ind[y[keep] % height, x[keep] % width] = 0.0
    return ind


def distance_from_seeds(points: torch.Tensor, mask: torch.Tensor, *,
                        height: int, width: int, metric: Distance) -> torch.Tensor:
    """Exact DT image ``(height, width)`` of integer seed pixels ``points
    (S, 2)`` ``(x, y)`` with validity ``mask (S,)``, on their device (K2
    for L2 and L2² on the card).  No valid seed: ``F32_MAX`` everywhere."""
    return dt_from_indicator(indicator_from_points(points, mask, height, width),
                             metric=metric)


def distance_transform(lines, size, metric: Distance = Distance.L2,
                       max_points: int | None = None, device="cuda") -> torch.Tensor:
    """DT of a line set on a ``(W, H) = size`` canvas (the reference's
    ``Size`` convention), on ``device``: each line clipped to the canvas and
    rasterized to at most ``max_points`` seeds (default ``hypot(W, H) + 2``),
    then :func:`distance_from_seeds`.  Reference ``imgproc.h:169-194``.  An
    empty line set gives ``F32_MAX`` everywhere."""
    device = resolve_device(device)
    lines = geo.as_lines(lines, device).to(device)
    w, h = int(size[0]), int(size[1])
    if lines.shape[0] == 0:
        return torch.full((h, w), F32_MAX, dtype=torch.float32, device=device)
    if max_points is None:
        max_points = int(np.hypot(w, h)) + 2
    pts, mask = draw.seed_points(lines, h, w, max_points)
    return distance_from_seeds(pts, mask, height=h, width=w, metric=metric)
