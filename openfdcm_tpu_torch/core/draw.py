"""Seed points of lines clipped to a canvas (port of :mod:`openfdcm_tpu.core.draw`)."""
from __future__ import annotations

import torch

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
