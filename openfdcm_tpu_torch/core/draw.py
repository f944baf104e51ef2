"""Seed points of lines clipped to a canvas, and line drawing (port of
:mod:`openfdcm_tpu.core.draw`; reference ``core/drawing.h:111-125``)."""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo
from . import rasterize as ras


def seed_points_box(lines: torch.Tensor, box: torch.Tensor, max_points: int):
    """Clip ``(..., N, 4)`` lines to ``box = (xmin, xmax, ymin, ymax)``
    (``(..., 4)``, broadcast against the lines' ``(..., N)``) and rasterize
    them to integer seed pixels — the clip and rasterize steps of
    ``drawLines`` (``drawing.h:116-123``).

    Returns ``(points (..., N, P, 2) int32 (x, y), mask (..., N, P))``.
    """
    clipped, keep = ras.clip_lines_masked_dyn(lines, box)
    pts, pmask = ras.rasterize_lines_masked(clipped, max_points)
    return pts, pmask & keep[..., None]


def seed_points(lines: torch.Tensor, height: int, width: int, max_points: int):
    """:func:`seed_points_box` on the ``height x width`` canvas, flattened:
    ``(points (N * max_points, 2), mask (N * max_points,))``."""
    box = torch.tensor([0.0, float(width - 1), 0.0, float(height - 1)],
                       dtype=torch.float32, device=lines.device)
    pts, mask = seed_points_box(lines, box, max_points)
    return pts.reshape(-1, 2), mask.reshape(-1)


def draw_lines(img: torch.Tensor, lines, color, max_points: int | None = None
               ) -> torch.Tensor:
    """Draw lines into ``img`` (``(H, W)``) with a constant color, on the
    image's device; returns a new image.  Reference ``drawing.h:111-125``.

    Points are scattered as the JAX package's drop-mode scatter places them:
    masked points are dropped, indices in ``[-size, -1]`` wrap and the rest
    of the out-of-range ones are dropped.  The mask is applied before the
    write: an out-of-range index on the card is a device assert."""
    lines = geo.as_lines(lines, img.device).to(img.device)
    if lines.shape[0] == 0:
        return img
    h, w = img.shape
    if max_points is None:
        d = (lines[:, 2:4] - lines[:, 0:2]).cpu().numpy()
        max_points = max(1, int(np.nanmax(np.trunc(np.maximum(
            np.minimum(np.abs(d[:, 0]), w), np.minimum(np.abs(d[:, 1]), h))))) + 1,
            int(np.trunc(max(w, h))) + 1)
        max_points = min(max_points, w + h + 2)
    pts, mask = seed_points(lines, h, w, max_points)
    x = pts[:, 0].to(torch.int64)
    y = pts[:, 1].to(torch.int64)
    keep = mask & (x >= -w) & (x < w) & (y >= -h) & (y < h)
    out = img.clone()
    out[y[keep] % h, x[keep] % w] = torch.as_tensor(color, dtype=img.dtype,
                                                    device=img.device)
    return out
