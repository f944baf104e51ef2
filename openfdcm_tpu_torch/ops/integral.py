"""Kernel K4: the directional line integral's sweep scan.

Per slice, a carry sweeps along the major axis: each step shifts the carry
one row by a delta in {-1, 0, +1} with zero fill, then adds the column
(``carry = col + shift(carry, delta)``, reference ``imgproc.h:38-84``);
``flip`` reverses the sweep over the physical axis.  Each output element is
one add of the same two operands as in the JAX package's ``_sweep_scan``
(``core/integral.py:104-115``), so results are bit-exact.

Replaces ``openfdcm_tpu/ops/integral_kernel.py::sweep_scan_tpu`` (Pallas
``_kernel``).  CUDA source: ``csrc/integral.cu``.
"""
from __future__ import annotations

import torch

from . import build


def sweep_scan_plain(imgs: torch.Tensor, deltas: torch.Tensor, flip: bool,
                     x_major: bool) -> torch.Tensor:
    """Plain PyTorch version, any device: a loop over sweep positions."""
    out = torch.empty_like(imgs)
    src = imgs if x_major else imgs.transpose(1, 2)   # (G, rows, N) views
    dst = out if x_major else out.transpose(1, 2)
    g, rows, n = src.shape
    carry = torch.zeros((g, rows), dtype=imgs.dtype, device=imgs.device)
    zero = torch.zeros((g, 1), dtype=imgs.dtype, device=imgs.device)
    for c in (range(n - 1, -1, -1) if flip else range(n)):
        d = deltas[:, c, None]
        down = torch.cat([zero, carry[:, :-1]], dim=1)
        up = torch.cat([carry[:, 1:], zero], dim=1)
        carry = src[:, :, c] + torch.where(d == 1, down,
                                           torch.where(d == -1, up, carry))
        dst[:, :, c] = carry
    return out


def sweep_scan(imgs: torch.Tensor, deltas: torch.Tensor, flip: bool,
               x_major: bool) -> torch.Tensor:
    """K4 on float32 ``imgs (G, H, W)`` with int32 per-position ``deltas
    (G, N)``: the sweep runs along W (``N = W``) when ``x_major``, else
    along H (``N = H``).  CUDA kernel for CUDA tensors, plain version for
    CPU tensors."""
    build.require(imgs, "imgs", torch.float32, 3)
    build.require(deltas, "deltas", torch.int32, 2)
    g, h, w = imgs.shape
    rows, n = (h, w) if x_major else (w, h)
    if deltas.shape != (g, n):
        raise ValueError(f"deltas {tuple(deltas.shape)}, need {(g, n)}")
    if not build.use_kernel(imgs, deltas):
        return sweep_scan_plain(imgs, deltas, flip, x_major)
    out = torch.empty_like(imgs)
    if imgs.numel():
        row_stride, col_stride = (w, 1) if x_major else (1, w)
        build.launch("fdcm_sweep", imgs.device, imgs.data_ptr(),
                     out.data_ptr(), deltas.data_ptr(), g, rows, n, h * w,
                     row_stride, col_stride, int(flip))
        sweep_scan.launches += 1
    return out


sweep_scan.launches = 0
