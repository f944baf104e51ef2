"""Kernel K4: the directional line integrals of a DT3 stack.

Per slice, a carry sweeps along the major axis: each step shifts the carry
one row by a delta in {-1, 0, +1} with zero fill, then adds the column
(``carry = col + shift(carry, delta)``, reference ``imgproc.h:38-84``);
``flip`` reverses the sweep over the physical axis.  Each output element is
one add of the same two operands as in the JAX package's ``_sweep_scan``
(``core/integral.py:104-115``), so results are bit-exact.

Replaces ``openfdcm_tpu/ops/integral_kernel.py::sweep_scan_tpu`` (Pallas
``_kernel``).  CUDA source: ``csrc/integral.cu`` (one thread per sweep
path, one launch per stack).
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import to_device
from . import build


def sweep_scan_plain(imgs: torch.Tensor, deltas: torch.Tensor, flip: bool,
                     x_major: bool, init=None) -> torch.Tensor:
    """The sweep of a slice group ``imgs (G, H, W)`` with per-position
    ``deltas (G, N)`` (``N = W`` when ``x_major``, else ``H``), any device:
    a loop over sweep positions.  ``init``: the carry ``(G, H)`` (``(G,
    W)`` when not ``x_major``) the sweep continues from, zero when None (a
    row block of the row-sharded build continues its predecessor's)."""
    out = torch.empty_like(imgs)
    src = imgs if x_major else imgs.transpose(1, 2)   # (G, rows, N) views
    dst = out if x_major else out.transpose(1, 2)
    g, rows, n = src.shape
    carry = (torch.zeros((g, rows), dtype=imgs.dtype, device=imgs.device)
             if init is None else init)
    zero = torch.zeros((g, 1), dtype=imgs.dtype, device=imgs.device)
    for c in (range(n - 1, -1, -1) if flip else range(n)):
        d = deltas[:, c, None]
        down = torch.cat([zero, carry[:, :-1]], dim=1)
        up = torch.cat([carry[:, 1:], zero], dim=1)
        carry = src[:, :, c] + torch.where(d == 1, down,
                                           torch.where(d == -1, up, carry))
        dst[:, :, c] = carry
    return out


def sweep_stack_plain(imgs: torch.Tensor, deltas: np.ndarray,
                      table: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version, any device: the slices grouped by ``(x_major,
    flip)``, each group gathered, swept by :func:`sweep_scan_plain` and
    written back into ``imgs``."""
    s, d, ph, pw = imgs.shape
    flat = imgs.view(s * d, ph, pw)
    for x_major in (True, False):
        n = pw if x_major else ph
        for flip in (False, True):
            sel = np.flatnonzero((table[:, 0] == x_major) & (table[:, 1] == flip))
            if not sel.size:
                continue
            idx = torch.as_tensor(sel, device=imgs.device)
            dsel = torch.as_tensor(np.ascontiguousarray(deltas[table[sel, 2], :n]),
                                   device=imgs.device)
            flat[idx] = sweep_scan_plain(flat[idx], dsel, flip, x_major)
    return imgs


def sweep_stack(imgs: torch.Tensor, deltas, table) -> torch.Tensor:
    """K4 on a float32 stack ``imgs (S, D, PH, PW)``, in place; returns
    ``imgs``.  Host arrays: ``deltas (R, N >= max(PH, PW))`` int32 delta
    rows by physical position; ``table (S*D, 3)`` per flat slice ``s*D + j``
    its ``(x_major, flip, delta row)``.  The sweep runs along PW (its first
    PW deltas) when ``x_major``, else along PH.  CUDA kernel for CUDA
    tensors, plain version for CPU tensors."""
    build.require(imgs, "imgs", torch.float32, 4)
    deltas = np.ascontiguousarray(deltas, np.int32)
    table = np.ascontiguousarray(table, np.int32)
    s, d, ph, pw = imgs.shape
    if deltas.ndim != 2 or deltas.shape[1] < max(ph, pw):
        raise ValueError(f"deltas {deltas.shape}: need (R, >= {max(ph, pw)})")
    if (table.shape != (s * d, 3) or not np.isin(table[:, :2], (0, 1)).all()
            or (table[:, 2] < 0).any() or (table[:, 2] >= deltas.shape[0]).any()):
        raise ValueError(f"table {table.shape}: need ({s * d}, 3) rows of "
                         f"(x_major 0/1, flip 0/1, delta row < {deltas.shape[0]})")
    if not build.use_kernel(imgs):
        return sweep_stack_plain(imgs, deltas, table)
    if imgs.numel():
        dev_d = to_device(deltas, imgs.device)
        dev_t = to_device(table, imgs.device)
        build.launch("fdcm_sweep_paths", imgs.device, imgs.data_ptr(),
                     dev_d.data_ptr(), dev_t.data_ptr(), s * d, ph, pw,
                     deltas.shape[1])
        sweep_stack.launches += 1
    return imgs


sweep_stack.launches = 0
