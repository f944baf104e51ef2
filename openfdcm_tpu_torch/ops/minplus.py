"""Kernel K2: the exact L2² / L2 row pass of the distance transform.

``out[..., y, x] = min_s (g[..., y, s]² + (x - s)²)`` over each row's
finite sources, where ``g`` holds the column-pass distances (integers in
``[0, H)``, ``F32_MAX`` for a column without a seed); then ``min(., F32_MAX)``
and, for L2, the IEEE square root of every finite value (``F32_MAX`` stays).

Replaces ``openfdcm_tpu/ops/minplus_kernel.py::minplus_rows_banded``
(Pallas ``_kernel``) and the row-direction L1 transform that gave it its
band.  CUDA source: ``csrc/minplus.cu`` (an exact integer lower envelope,
O(W) per row).  Canvases with a side above :data:`MAX_SIDE` run the same
kernel on 64-bit arithmetic (:func:`minplus_rows_wide`).
"""
from __future__ import annotations

import torch

from . import build
from ..core.geometry import sqrt_f32
from ..core.types import F32_MAX

# The kernel's exact int32 arithmetic holds for H, W <= 16384; larger
# canvases run its 64-bit arithmetic.
MAX_SIDE = 16384
# Resident one-warp blocks an SM can hold (Hopper): the kernel's grid, and
# so its scratch, is at most this many per SM.
BLOCKS_PER_SM = 32


def minplus_rows_plain(g: torch.Tensor, *, sqrt: bool) -> torch.Tensor:
    """Plain PyTorch version, any device: the band scan over ``s in [x - l1,
    x + l1]`` (``l1`` the exact L1 distance of the same seeds, which bounds
    the winning source's offset), one shifted-min pass per offset."""
    from ..core.dt import _nearest_1d_l1   # core.dt imports this module
    w = g.shape[-1]
    rows = g.reshape(-1, w)
    g2 = rows * rows                 # F32_MAX² overflows to inf on purpose
    l1 = _nearest_1d_l1(rows)
    out = g2.clone()
    finite = l1 < F32_MAX
    radius = int(torch.clamp_max(l1[finite].max(), w - 1)) if bool(finite.any()) else 0
    for d in range(1, radius + 1):
        dd = float(d * d)
        right = out[:, d:]                       # sources left of the pixel
        torch.minimum(right, g2[:, :-d] + dd, out=right)
        left = out[:, :-d]                       # sources right of the pixel
        torch.minimum(left, g2[:, d:] + dd, out=left)
    out = torch.clamp_max(out, F32_MAX)
    if sqrt:
        out = torch.where(out >= F32_MAX, out, sqrt_f32(out))
    return out.reshape(g.shape)


def scratch_blocks(n: int, device) -> int:
    """The kernel's grid for ``n`` rows: one block per 32 rows, at most
    :data:`BLOCKS_PER_SM` an SM.  Its scratch, ``blocks * 32 * W`` entries
    (32-bit, 64-bit in :func:`minplus_rows_wide`), never exceeds the output
    rounded up to 32 rows (twice that when wide); on an H100 (132 SMs) a
    10-scene 30 x 640² build takes 4224 blocks, 346 MB of scratch beside its
    491 MB output."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-n // 32), sms * BLOCKS_PER_SM)


def _check(g: torch.Tensor) -> None:
    if g.ndim < 2:
        raise ValueError(f"g: need (..., H, W), got {tuple(g.shape)}")
    build.require(g, "g", torch.float32, g.ndim)


def _launch(entry: str, g: torch.Tensor, sqrt: bool, dtype) -> torch.Tensor:
    """``entry`` on ``g``'s rows with a scratch of ``dtype`` entries."""
    out = torch.empty_like(g)
    w = g.shape[-1]
    n = g.numel() // w
    blocks = scratch_blocks(n, g.device)
    # each block's 32 envelope stacks of up to w entries
    scratch = torch.empty(blocks * 32 * w, dtype=dtype, device=g.device)
    build.launch(entry, g.device, g.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), blocks, n, w, int(sqrt))
    return out


def minplus_rows(g: torch.Tensor, *, sqrt: bool) -> torch.Tensor:
    """K2 on float32 column-pass distances ``g (..., H, W)`` of any size
    (device memory bounds the canvas): the CUDA kernel for CUDA tensors
    (:func:`minplus_rows_wide` when ``max(H, W) > MAX_SIDE``), the plain
    version for CPU tensors.  ``sqrt``: L2 (else L2²)."""
    _check(g)
    if not build.use_kernel(g):
        return minplus_rows_plain(g, sqrt=sqrt)
    if max(g.shape[-2:]) > MAX_SIDE:
        return minplus_rows_wide(g, sqrt=sqrt)
    if not g.numel():
        return torch.empty_like(g)
    out = _launch("fdcm_minplus_rows", g, sqrt, torch.int32)
    minplus_rows.launches += 1
    return out


def minplus_rows_wide(g: torch.Tensor, *, sqrt: bool) -> torch.Tensor:
    """K2 on 64-bit envelope arithmetic, for any ``(..., H, W)`` (the
    kernel behind :func:`minplus_rows` on canvases with a side above
    :data:`MAX_SIDE`): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check(g)
    if not build.use_kernel(g):
        return minplus_rows_plain(g, sqrt=sqrt)
    if not g.numel():
        return torch.empty_like(g)
    out = _launch("fdcm_minplus_rows_wide", g, sqrt, torch.int64)
    minplus_rows_wide.launches += 1
    return out


minplus_rows.launches = 0
minplus_rows_wide.launches = 0
