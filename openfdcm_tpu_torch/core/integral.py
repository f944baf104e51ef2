"""Directional line integrals (port of :mod:`openfdcm_tpu.core.integral`).

Each DT3 slice is prefix-summed along its own angle: sweeping the major
axis, each position adds the previous carry shifted by
``delta_i = round(i*r) - round((i-1)*r)`` rows (reference
``core/imgproc.h:38-84``).  The sweep runs on kernel K4
(:mod:`openfdcm_tpu_torch.ops.integral`), one launch for a whole scene
batch, in place (:func:`line_integral_stack_batch_`, the DT3 build's);
:func:`line_integral_stack` and :func:`line_integral` take the JAX
package's arguments and return a new tensor.  Physical canvases may be
padded beyond each scene's logical region; padded cells are zero and the
sweep geometry keeps the logical region reference-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.integral import sweep_stack


def sweep_spec(angle: float):
    """Host-side sweep geometry ``(x_major, flip, r_minor)`` at a static
    angle, in f32 like the reference (``imgproc.h:42-57``)."""
    c = np.float32(np.cos(np.float32(angle)))
    s = np.float32(np.sin(np.float32(angle)))
    tan = s / c
    if -1.0 <= tan < 1.0:  # x-major
        cond = c < 0
        rv = (np.float32(1 - 2 * cond), np.float32(tan - 2.0 * cond * tan))
    else:
        cond = s < 0
        inv = np.float32(1.0) / tan
        rv = (np.float32(inv - 2.0 * cond * inv), np.float32(1 - 2 * cond))
    x_major = abs(float(rv[0])) == 1.0
    if x_major:
        return True, float(rv[0]) < 0, rv[1]
    return False, float(rv[1]) < 0, rv[0]


def _deltas(r: np.float32, n: int) -> np.ndarray:
    """delta_i = round(i*r) - round((i-1)*r) (std::round, f32), delta_0 = 0."""
    i = np.arange(n, dtype=np.float32)
    prod = i * np.float32(r)
    s = (np.sign(prod) * np.floor(np.abs(prod) + np.float32(0.5))).astype(np.int32)
    d = np.zeros(n, np.int32)
    d[1:] = s[1:] - s[:-1]
    return d


def sweep_tables(angles, logical_hw, phys_h: int, phys_w: int):
    """Host tables of K4 for a scene batch: ``(deltas (R, max(PH, PW)),
    table (S*D, 3))``, per flat slice ``s*D + j`` its ``(x_major, flip,
    delta row)``.  An unflipped slice's deltas are shared by every scene; a
    flipped sweep is a reversed sweep over the physical axis whose position
    ``c`` takes the delta of sweep position ``n_log - 1 - c`` (0 in the
    padding), so it takes a row per scene, as in the JAX package."""
    logical_hw = np.asarray(logical_hw, np.int64).reshape(-1, 2)
    s, d = logical_hw.shape[0], len(angles)
    width = max(phys_h, phys_w)
    table = np.zeros((s, d, 3), np.int32)
    rows = []
    for j, angle in enumerate(angles):
        x_major, flip, r = sweep_spec(float(angle))
        n_phys = phys_w if x_major else phys_h
        dl = _deltas(r, n_phys)
        if flip:
            n_log = logical_hw[:, 1] if x_major else logical_hw[:, 0]     # (S,)
            col = np.arange(n_phys)
            pidx = np.clip(n_log[:, None] - 1 - col[None, :], 0, n_phys - 1)
            per_scene = np.where(col[None, :] < n_log[:, None], dl[pidx], 0)
        else:
            per_scene = dl[None]
        table[:, j, 0], table[:, j, 1] = x_major, flip
        table[:, j, 2] = len(rows) + (np.arange(s) if flip else 0)
        rows += [np.pad(row, (0, width - n_phys)) for row in per_scene]
    deltas = np.stack(rows).astype(np.int32) if rows else np.zeros((0, width), np.int32)
    return deltas, table.reshape(s * d, 3)


def sweep_groups(angles, logical_hw, phys_h: int, phys_w: int):
    """One scene's slices grouped by sweep, from :func:`sweep_tables`:
    ``[(x_major, flip, slices (G,), deltas (G, N))]``, ``N`` the swept
    physical axis (PW when ``x_major``, else PH) and each slice's deltas by
    physical position (JAX ``core.integral._group_geometry`` with the flip
    mapping applied)."""
    deltas, table = sweep_tables(angles, [logical_hw], phys_h, phys_w)
    groups = []
    for x_major in (True, False):
        n = phys_w if x_major else phys_h
        for flip in (False, True):
            sel = np.flatnonzero((table[:, 0] == x_major) & (table[:, 1] == flip))
            if sel.size:
                groups.append((x_major, flip, sel, deltas[table[sel, 2], :n]))
    return groups


def line_integral_stack_batch_(imgs: torch.Tensor, angles, logical_hw) -> torch.Tensor:
    """Line integrals of a scene batch ``(S, D, PH, PW)``, one static angle
    per slice, computed in place (one K4 launch); returns ``imgs``.
    ``logical_hw``: host ``(S, 2)`` ints ``(H, W)``; each scene's padding
    beyond it must be zero."""
    _, _, ph, pw = imgs.shape
    deltas, table = sweep_tables(angles, logical_hw, ph, pw)
    return sweep_stack(imgs, deltas, table)


def line_integral_stack(imgs: torch.Tensor, angles, logical_hw=None) -> torch.Tensor:
    """Line integrals of a ``(D, PH, PW)`` stack, one static angle per
    slice, as a new tensor (``imgs`` is left as it is).  ``logical_hw``:
    ``(H, W)``, default ``(PH, PW)``; the padding beyond it must be zero and
    stays out of the reference-exact index pattern."""
    d, ph, pw = imgs.shape
    if len(angles) != d:
        raise ValueError(f"{len(angles)} angles for {d} slices")
    if logical_hw is None:
        logical_hw = (ph, pw)
    if torch.is_tensor(logical_hw):
        logical_hw = logical_hw.cpu()
    lhw = np.asarray(logical_hw, np.int64).reshape(1, 2)
    out = imgs.to(torch.float32, copy=True).contiguous()
    return line_integral_stack_batch_(out[None], angles, lhw)[0]


def line_integral(img: torch.Tensor, angle: float) -> torch.Tensor:
    """Line integral of one image ``(H, W)`` along ``angle``, as a new
    tensor (K4 on the card).  Reference ``imgproc.h:38-84``."""
    h, w = img.shape
    return line_integral_stack(img[None], [angle], (h, w))[0]
