"""Kernel K2: the exact L2² row pass of the distance transform.

``out[r, x] = min_s (g2[r, s] + (x - s)²)`` over each row, where ``g2`` is
the squared column-pass distance and ``l1`` the exact L1 distance of the
same seed set.  The winning source lies within ``|x - s| <= d_L2 <= d_L1``
of its pixel, so scanning ``s in [x - l1, x + l1]`` is exact; every value
is an integer below 2^24 (or ``inf``), so the min is exact in any order.

Replaces ``openfdcm_tpu/ops/minplus_kernel.py::minplus_rows_banded``
(Pallas ``_kernel``), which prunes per 128x128 tile by the same L1 bound.
CUDA source: ``csrc/minplus.cu``.
"""
from __future__ import annotations

import torch

from . import build
from ..core.types import F32_MAX


def minplus_rows_plain(g2: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, any device: one shifted-min pass per source
    offset, up to the largest finite L1 radius (rows without any seed hold
    ``g2 = inf`` and stay ``inf``)."""
    w = g2.shape[-1]
    out = g2.clone()
    finite = l1 < F32_MAX
    radius = int(torch.clamp_max(l1[finite].max(), w - 1)) if bool(finite.any()) else 0
    for d in range(1, radius + 1):
        dd = float(d * d)
        right = out[:, d:]                       # sources left of the pixel
        torch.minimum(right, g2[:, :-d] + dd, out=right)
        left = out[:, :-d]                       # sources right of the pixel
        torch.minimum(left, g2[:, d:] + dd, out=left)
    return out


def minplus_rows(g2: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """K2 on ``(N, W)`` float32 rows: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    build.require(g2, "g2", torch.float32, 2)
    build.require(l1, "l1", torch.float32, 2)
    if g2.shape != l1.shape:
        raise ValueError(f"g2 {tuple(g2.shape)} and l1 {tuple(l1.shape)} differ")
    if not build.use_kernel(g2, l1):
        return minplus_rows_plain(g2, l1)
    n, w = g2.shape
    out = torch.empty_like(g2)
    if n:
        build.launch("fdcm_minplus_rows", g2.device, g2.data_ptr(),
                     l1.data_ptr(), out.data_ptr(), n, w)
        minplus_rows.launches += 1
    return out


minplus_rows.launches = 0
