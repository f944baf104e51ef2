"""Vectorized line clipping and rasterization in PyTorch
(port of :mod:`openfdcm_tpu.core.rasterize`).

Rounding matches ``std::round`` (half away from zero), not banker's
rounding.  All functions broadcast over leading batch axes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo

_INSIDE, _LEFT, _RIGHT, _BOTTOM, _TOP = 0, 1, 2, 4, 8
# Float coordinates are clamped to +-2^24 before any float->int conversion:
# the conversion of a NaN or out-of-range float is undefined in PyTorch.
COORD_CLAMP = float(2 ** 24)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``std::round`` semantics: round half away from zero."""
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def to_int_trunc(x: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """``trunc(x)`` as an integer tensor, NaN and out-of-range values first
    clamped to ``[-2^24, 2^24]`` (NaN to the low end) so the conversion is
    defined on every device."""
    x = torch.nan_to_num(x, nan=-COORD_CLAMP).clamp(-COORD_CLAMP, COORD_CLAMP)
    return torch.trunc(x).to(dtype)


def to_int32_sat(x: torch.Tensor) -> torch.Tensor:
    """``trunc(x)`` as int32 with XLA's conversion semantics, which the JAX
    package's ``astype(int32)`` has on the CPU: saturating at the int32
    range, NaN to 0.  The rasterizer converts with it, so a line with a NaN
    or far endpoint seeds the pixels the JAX package seeds."""
    x = torch.nan_to_num(x.double(), nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return torch.trunc(x).to(torch.int32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``a*b + c`` with one rounding (a fused
    multiply-add), on any device.

    WHY: XLA:CPU contracts the rasterizer's ``a + (b - a) * frac`` into an
    FMA (measured: without it, 36 seed points of 20,000 random lines round
    differently), and the DT3 stack must be bit-equal to the JAX package on
    the CPU.  PyTorch has no fma op, so this computes it in f64: the
    product of two f32 values is exact there, TwoSum gives the exact error
    of the f64 sum, and rounding that sum to odd before the final f32
    rounding makes the double rounding exact (53 >= 24 + 2 bits)."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def rasterize_vector(vec: torch.Tensor) -> torch.Tensor:
    """Scale a 2-vector so its max-abs component is exactly +-1, keeping the
    angle.  Reference ``core/drawing.h:57-67``; a null vector gives NaN."""
    vx, vy = vec[..., 0], vec[..., 1]
    tan = vy / vx
    b1 = (tan >= -1.0) & (tan < 1.0)
    c1 = (vx < 0).float()
    r1 = torch.stack([1.0 - 2.0 * c1, tan - 2.0 * c1 * tan], dim=-1)
    c2 = (vy < 0).float()
    inv = 1.0 / tan
    r2 = torch.stack([inv - 2.0 * c2 * inv, 1.0 - 2.0 * c2], dim=-1)
    return torch.where(b1[..., None], r1, r2)


def _outcode(x, y, box):
    xmin, xmax, ymin, ymax = box
    code = torch.where(x < xmin, _LEFT, torch.where(x > xmax, _RIGHT, _INSIDE))
    return code | torch.where(y < ymin, _BOTTOM,
                              torch.where(y > ymax, _TOP, _INSIDE))


def _clip_one_endpoint(px, py, qx, qy, code, box):
    """Clip ``(px, py)`` against one boundary, priority TOP > BOTTOM > RIGHT
    > LEFT (``drawing.cpp:86-97``)."""
    xmin, xmax, ymin, ymax = box
    top = (code & _TOP) != 0
    bottom = ((code & _BOTTOM) != 0) & ~top
    right = ((code & _RIGHT) != 0) & ~top & ~bottom
    left = ((code & _LEFT) != 0) & ~top & ~bottom & ~right

    y_crop = torch.where(top, ymax, ymin)
    nx_y = px + (qx - px) * (y_crop - py) / (qy - py)
    x_crop = torch.where(right, xmax, xmin)
    ny_x = py + (qy - py) * (x_crop - px) / (qx - px)

    use_y = top | bottom
    use_x = right | left
    new_x = torch.where(use_y, nx_y, torch.where(use_x, x_crop, px))
    new_y = torch.where(use_y, y_crop, torch.where(use_x, ny_x, py))
    return new_x, new_y


def clip_lines_masked_dyn(lines: torch.Tensor, box: torch.Tensor):
    """Cohen–Sutherland clip of ``(..., N, 4)`` lines against
    ``box = (xmin, xmax, ymin, ymax)``, shaped ``(..., 4)`` with leading axes
    broadcastable to the lines' ``(..., N)``; fixed 8 iterations.

    Returns ``(clipped_lines, keep_mask)``; lines fully outside get
    ``keep=False`` and keep their coordinates.  Reference
    ``drawing.cpp:29-112``."""
    box = tuple(box[..., i].expand(lines.shape[:-1]) for i in range(4))
    x1, y1, x2, y2 = lines.unbind(-1)
    keep = torch.zeros(x1.shape, dtype=torch.bool, device=lines.device)
    purge = torch.zeros_like(keep)
    for _ in range(8):
        c1 = _outcode(x1, y1, box)
        c2 = _outcode(x2, y2, box)
        active = ~(keep | purge)
        both_in = (c1 == 0) & (c2 == 0)
        same_side = (c1 & c2) != 0
        keep = keep | (active & both_in)
        purge = purge | (active & same_side)
        active = active & ~both_in & ~same_side
        clip_p1 = active & (c1 != 0)
        clip_p2 = active & (c1 == 0)
        nx1, ny1 = _clip_one_endpoint(x1, y1, x2, y2, c1, box)
        nx2, ny2 = _clip_one_endpoint(x2, y2, x1, y1, c2, box)
        x1 = torch.where(clip_p1, nx1, x1)
        y1 = torch.where(clip_p1, ny1, y1)
        x2 = torch.where(clip_p2, nx2, x2)
        y2 = torch.where(clip_p2, ny2, y2)
    return torch.stack([x1, y1, x2, y2], dim=-1), keep


def clip_lines_masked(lines: torch.Tensor, box):
    """:func:`clip_lines_masked_dyn` against a fixed host ``box = (xmin,
    xmax, ymin, ymax)``."""
    return clip_lines_masked_dyn(lines, torch.tensor(
        [float(v) for v in box], dtype=torch.float32, device=lines.device))


def clip_lines(lines, box, delete_oob: bool = True, device="cuda") -> np.ndarray:
    """Host-facing clip with the reference's output conventions
    (``core/drawing.h:50``, ``drawing.cpp:64-112``): with ``delete_oob``
    the lines outside ``box = (xmin, xmax, ymin, ymax)`` are removed,
    otherwise replaced by a singular ``(0, 0)`` point.  Computed on the
    lines' device (host lines go to ``device``)."""
    arr = geo.as_lines(lines, device)
    if arr.shape[0] == 0:
        return np.zeros((0, 4), np.float32)
    clipped, keep = clip_lines_masked(arr, box)
    clipped = clipped.cpu().numpy()
    keep = keep.cpu().numpy()
    if delete_oob:
        return clipped[keep]
    clipped[~keep] = 0.0
    return clipped


def raster_size(lines: torch.Tensor) -> torch.Tensor:
    """Rasterized points per line, ``trunc(max(|dx|, |dy|)) + 1`` int32
    (the per-branch sizes of ``drawing.h:82-97``); NaN and out-of-range
    extents convert as XLA converts them (:func:`to_int32_sat`)."""
    d = lines[..., 2:4] - lines[..., 0:2]
    return to_int32_sat(torch.maximum(d[..., 0].abs(), d[..., 1].abs())) + 1


def rasterize_line(line, device="cuda") -> np.ndarray:
    """Host-facing single-line rasterization: ``(2, K)`` ints, rows ``(x,
    y)`` (reference layout, ``drawing.h:74``); a degenerate line (``|p2 -
    p1| <= 1e-5``) is one point."""
    arr = geo.as_lines(line, device)
    k = int(raster_size(arr)[0])
    if bool(((arr[0, 2:4] - arr[0, 0:2]).abs() <= 1e-5).all()):
        k = 1
    pts, _ = rasterize_lines_masked(arr, k)
    return pts[0].cpu().numpy().T


def rasterize_lines_masked(lines: torch.Tensor, max_points: int):
    """Rasterize ``(..., N, 4)`` lines onto a static ``(..., N, P, 2)`` int32
    grid with a validity mask ``(..., N, P)``.

    Point ``i`` is ``round(p1 + i * (p2 - p1) / (size - 1))`` (Eigen
    ``LinSpaced`` + round, ``drawing.h:97-101``) with the product and add
    fused as XLA:CPU fuses them (:func:`fma_f32`), sizes and points
    converted to int32 as XLA converts them (:func:`to_int32_sat`).  A degenerate line
    (``|p2 - p1| <= 1e-5``) gives the single point ``round(p1)``."""
    a = lines[..., 0:2]
    b = lines[..., 2:4]
    d = b - a
    size = raster_size(lines)
    degenerate = (d.abs() <= 1e-5).all(dim=-1)
    size = torch.where(degenerate, torch.ones_like(size), size)

    i = torch.arange(max_points, dtype=torch.float32, device=lines.device)
    denom = torch.clamp_min(size - 1, 1).float()
    frac = i / denom[..., None]                                  # (..., N, P)
    pts = fma_f32(d[..., None, :], frac[..., None], a[..., None, :])
    single = torch.where(degenerate[..., None], a, b)
    pts = torch.where((size == 1)[..., None, None], single[..., None, :], pts)
    pts = to_int32_sat(round_half_away(pts))
    mask = i < size[..., None].float()
    return pts, mask
