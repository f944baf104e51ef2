"""Kernel K2: the exact L2² / L2 row pass of the distance transform.

``out[..., y, x] = min_s (g[..., y, s]² + (x - s)²)`` over each row's
finite sources, where ``g`` holds the column-pass distances (integers in
``[0, H)``, ``F32_MAX`` for a column without a seed); then ``min(., F32_MAX)``
and, for L2, the IEEE square root of every finite value (``F32_MAX`` stays).

Replaces ``openfdcm_tpu/ops/minplus_kernel.py::minplus_rows_banded``
(Pallas ``_kernel``) and the row-direction L1 transform that gave it its
band.  CUDA source: ``csrc/minplus.cu`` (an exact integer lower envelope,
O(W) per row).
"""
from __future__ import annotations

import torch

from . import build
from ..core.geometry import sqrt_f32
from ..core.types import F32_MAX

# The kernel's exact int32 arithmetic holds for H, W <= 16384.
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
    :data:`BLOCKS_PER_SM` an SM.  Its scratch, ``blocks * 32 * W`` int32
    words, never exceeds the output rounded up to 32 rows; on an H100 (132
    SMs) a 10-scene 30 x 640² build takes 4224 blocks, 346 MB of scratch
    beside its 491 MB output."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-n // 32), sms * BLOCKS_PER_SM)


def minplus_rows(g: torch.Tensor, *, sqrt: bool) -> torch.Tensor:
    """K2 on float32 column-pass distances ``g (..., H, W)``, ``H, W <=
    16384``: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``sqrt``: L2 (else L2²)."""
    if g.ndim < 2:
        raise ValueError(f"g: need (..., H, W), got {tuple(g.shape)}")
    build.require(g, "g", torch.float32, g.ndim)
    h, w = g.shape[-2:]
    if h > MAX_SIDE or w > MAX_SIDE:
        raise ValueError(f"g: rows of {w} and columns of {h} pixels; the "
                         f"kernel takes at most {MAX_SIDE} of each")
    if not build.use_kernel(g):
        return minplus_rows_plain(g, sqrt=sqrt)
    out = torch.empty_like(g)
    if g.numel():
        n = g.numel() // w
        blocks = scratch_blocks(n, g.device)
        # each block's 32 envelope stacks of up to w entries
        scratch = torch.empty(blocks * 32 * w, dtype=torch.int32, device=g.device)
        build.launch("fdcm_minplus_rows", g.device, g.data_ptr(), out.data_ptr(),
                     scratch.data_ptr(), blocks, n, w, int(sqrt))
        minplus_rows.launches += 1
    return out


minplus_rows.launches = 0
