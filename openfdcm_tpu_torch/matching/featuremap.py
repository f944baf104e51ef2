"""DT3 feature map pieces (port of :mod:`openfdcm_tpu.matching.featuremap`).

The DT3 stack is one dense ``f32[S, depth, H, W]`` tensor: per orientation
slice the exact DT of that slice's scene lines, min-propagated across
orientations (kernel K3), then line-integrated along each slice's angle
(kernel K4).  Host-side numpy helpers are copied from the JAX package as
they are: their f32 op order is part of the numerics contract.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from ..core import draw
from ..core.types import Distance, F32_MAX
from ..ops.prop import propagate_orientation


@dataclasses.dataclass(frozen=True)
class Dt3Params:
    """Reference ``Dt3CpuParameters`` (``dt3cpu.h:34-42``) + distance."""
    depth: int = 30
    dt3_coeff: float = 5.0
    padding: float = 2.2
    distance: Distance = Distance.L2


def scene_centered_translation(scene: np.ndarray, padding: float):
    """Returns ``(translation f32(2,), (width, height))``; all math in f32
    (reference ``dt3cpu.cpp:109-116``)."""
    pts = np.asarray(scene, np.float32).reshape(-1, 2)
    min_pt = pts.min(axis=0)
    max_pt = pts.max(axis=0)
    ratio = np.float32(max(1.0, padding))
    required_max = ratio * np.float32((max_pt - min_pt).max()) * np.ones(2, np.float32)
    translation = required_max / np.float32(2) - (max_pt + min_pt) / np.float32(2)
    size = np.ceil(required_max + np.float32(1)).astype(np.int64)
    return translation, (int(size[0]), int(size[1]))


def make_angles(depth: int) -> np.ndarray:
    """``i*pi/depth - pi/2`` in f32, ascending.  Reference ``dt3cpu.h:188-190``."""
    i = np.arange(depth, dtype=np.float32)
    return (i * np.float32(math.pi) / np.float32(depth) - np.float32(math.pi / 2)).astype(np.float32)


def _classify_theta_np(theta: float, angles: np.ndarray) -> int:
    """Scalar nearest-angle classification in numpy f32 (``dt3cpu.h:93-114``)."""
    theta = np.float32(theta)
    d = len(angles)
    u = int(np.sum(angles <= theta))
    if 0 < u < d:
        lo, hi = u - 1, u
        return lo if abs(theta - angles[lo]) < abs(theta - angles[hi]) else hi
    a1 = theta - angles[0]
    a2 = theta - angles[d - 1]
    if min(a1, abs(a1 - np.pi)) < min(a2, abs(a2 - np.pi)):
        return 0
    return d - 1


def _f32_ord(x) -> int:
    """Total-order key of a float32 (monotone int; NaN excluded)."""
    b = int(np.float32(x).view(np.int32))
    return (b + 0x80000000) if b >= 0 else ~b


def _f32_unord(o: int) -> np.float32:
    b = (o - 0x80000000) if o >= 0x80000000 else ~o
    return np.int32(b).view(np.float32)


@lru_cache(maxsize=None)
def orientation_ratio_splits(depth: int):
    """f32 thresholds turning nearest-angle classification into pure ratio
    (``dy/dx``) comparisons — ``(splits (depth-1,), wrap)``; no device
    ``atan``.  Copied from the JAX package (``featuremap.py:200-271``)."""
    angles = make_angles(depth)

    def cls(r) -> int:
        with np.errstate(all="ignore"):
            return _classify_theta_np(np.arctan(np.float32(r)), angles)

    assert cls(-np.inf) == 0 and cls(np.inf) == 0, "wrap structure"

    def bisect(lo_o, hi_o, pred):
        while hi_o - lo_o > 1:
            mid = (lo_o + hi_o) // 2
            if pred(_f32_unord(mid)):
                hi_o = mid
            else:
                lo_o = mid
        return hi_o

    lo = _f32_ord(-np.inf)
    top = _f32_ord(np.inf)
    splits = []
    for i in range(1, depth):
        hi = _f32_ord(np.float32(np.tan(np.float64(angles[i])
                                        + np.pi / (4 * depth))))
        while cls(_f32_unord(hi)) < i:
            hi = min(top, hi + (hi - lo))
        o = bisect(lo, hi, lambda r, i=i: cls(r) >= i)
        splits.append(_f32_unord(o))
        lo = o
    wrap_o = bisect(lo, top, lambda r: cls(r) == 0)
    wrap = _f32_unord(wrap_o)

    probes = [np.float32(0), np.float32(np.inf), np.float32(-np.inf)]
    for t in splits + [wrap]:
        o = _f32_ord(t)
        probes += [_f32_unord(max(_f32_ord(-np.inf), o - k)) for k in range(3)]
        probes += [_f32_unord(min(top, o + k)) for k in range(1, 3)]
    sp = np.asarray(splits, np.float32)
    for r in probes:
        table = 0 if r >= wrap else int(np.sum(r >= sp))
        want = cls(r)
        assert table == want, (float(r), table, want)
    return tuple(float(s) for s in splits), float(wrap)


def classify_lines(depth: int, lines: torch.Tensor) -> torch.Tensor:
    """Orientation-slice index per line (``(..., 4)`` -> ``(...)`` int64):
    nearest-angle semantics of ``theta = atan(dy/dx)`` evaluated in ratio
    space (``r = dy/dx``: ``sum(r >= splits)``, ``r >= wrap -> 0``,
    ``NaN -> depth-1``)."""
    splits, wrap = orientation_ratio_splits(depth)
    sp = torch.tensor(splits, dtype=torch.float32, device=lines.device)
    d = lines[..., 2:4] - lines[..., 0:2]
    r = d[..., 1] / d[..., 0]
    idx = (r[..., None] >= sp).sum(dim=-1)
    idx = torch.where(r >= wrap, torch.zeros_like(idx), idx)
    return torch.where(torch.isnan(r), torch.full_like(idx, depth - 1), idx)


def propagation_steps(angles, coeff: float):
    """The reference's relaxation schedule (``dt3cpu.cpp:86-107``): 1.5
    forward + 1.5 backward cycles of ``(src, dst, weight)`` edges with
    ``weight = coeff * min(|da|, |da - pi|)`` in f32."""
    m = len(angles)
    a = np.asarray(angles, np.float32)
    out = []

    def add(c, step):
        c1 = (m + ((c - step) % m)) % m
        c2 = (m + (c % m)) % m
        h = np.float32(abs(np.float32(a[c1]) - np.float32(a[c2])))
        w = np.float32(coeff) * np.minimum(h, np.abs(h - np.float32(math.pi)))
        out.append((c1, c2, float(w)))

    for c in range(0, int(math.ceil(1.5 * m))):
        add(c, 1)
    c = m
    end = -int(math.floor(1.5 * m))
    while c != end:
        add(c, -1)
        c -= 1
    return tuple(out)


def propagate_orientation_relax(dt3: torch.Tensor, steps) -> torch.Tensor:
    """Reference-order sequential relaxation across the orientation axis of
    ``dt3 (..., D, H, W)`` — kernel K3, in place: returns ``dt3``."""
    return propagate_orientation(dt3, steps)


def _indicator_batch(lines, line_mask, logical_hw, *, depth, phys_h, phys_w,
                     max_points):
    """Seed-indicator stack ``(S, depth, PH, PW)``: 0.0 at each line's
    rasterized seed pixels in its orientation slice, ``F32_MAX`` elsewhere.

    ``lines (S, N, 4)``, ``line_mask (S, N)`` and ``logical_hw (S, 2)``
    tensors.  Seeds outside the stack are dropped, as the JAX package's
    drop-mode scatter drops them."""
    s = lines.shape[0]
    slice_of_line = classify_lines(depth, lines)                    # (S, N)
    lhw = logical_hw.to(torch.float32)
    zero = torch.zeros_like(lhw[:, 0])
    box = torch.stack([zero, lhw[:, 1] - 1.0, zero, lhw[:, 0] - 1.0], dim=-1)
    pts, pmask = draw.seed_points_box(lines, box[:, None, :], max_points)
    pmask = pmask & line_mask[..., None]
    per_scene = depth * phys_h * phys_w
    x = pts[..., 0].to(torch.int64)
    y = pts[..., 1].to(torch.int64)
    flat = (slice_of_line[..., None] * (phys_h * phys_w) + y * phys_w + x
            + (torch.arange(s, device=lines.device) * per_scene)[:, None, None])
    pmask = pmask & (x >= 0) & (x < phys_w) & (y >= 0) & (y < phys_h)
    ind = torch.full((s * per_scene,), F32_MAX, dtype=torch.float32,
                     device=lines.device)
    ind[flat[pmask]] = 0.0
    return ind.reshape(s, depth, phys_h, phys_w)


def _logical_mask(logical_hw: torch.Tensor, phys_h: int, phys_w: int):
    """``(S, PH, PW)`` mask of each scene's logical region."""
    ys = torch.arange(phys_h, device=logical_hw.device)[None, :, None]
    xs = torch.arange(phys_w, device=logical_hw.device)[None, None, :]
    return (ys < logical_hw[:, 0, None, None]) & (xs < logical_hw[:, 1, None, None])


def minmax_translation_raw(tmpl: torch.Tensor, align_vec: torch.Tensor,
                           size_wh: torch.Tensor, extra_translation: torch.Tensor,
                           line_mask: torch.Tensor):
    """Legal ``(neg, pos)`` step multipliers along ``align_vec``: intersect
    the template bbox's movement ray with the four image borders (reference
    ``dt3cpu.cpp:30-75``).  ``tmpl (..., L, 4)``, ``align_vec (..., 2)``;
    ``(inf, inf)`` for a null align vector, ``(nan, nan)`` when the template
    already leaves the image."""
    inf = float("inf")
    pts = tmpl.reshape(*tmpl.shape[:-1], 2, 2)
    lm = line_mask[..., None, None]
    min_pt = torch.where(lm, pts, inf).amin(dim=(-3, -2)) + extra_translation
    max_pt = torch.where(lm, pts, -inf).amax(dim=(-3, -2)) + extra_translation

    oob = ((size_wh - 1 - max_pt) < 0).any(dim=-1) | (min_pt < 0).any(dim=-1)

    mult = torch.stack([-max_pt, -min_pt, size_wh - max_pt - 1.0,
                        size_wh - min_pt - 1.0], dim=-1)           # (..., 2, 4)
    mult = mult / align_vec[..., None]
    negative = torch.signbit(mult)
    pos_c = torch.where(negative, inf, mult)
    neg_c = torch.where(negative, mult, -inf)

    nan = float("nan")
    neg_ax = torch.where(torch.isnan(neg_c).any(dim=-1), nan, neg_c.amax(dim=-1))
    pos_ax = torch.where(torch.isnan(pos_c).any(dim=-1), nan, pos_c.amin(dim=-1))

    both_finite = (torch.isfinite(neg_ax).all(dim=-1)
                   & torch.isfinite(pos_ax).all(dim=-1))
    x_finite = torch.isfinite(neg_ax[..., 0]) & torch.isfinite(pos_ax[..., 0])
    neg = torch.where(both_finite, neg_ax.amax(dim=-1),
                      torch.where(x_finite, neg_ax[..., 0], neg_ax[..., 1]))
    pos = torch.where(both_finite, pos_ax.amin(dim=-1),
                      torch.where(x_finite, pos_ax[..., 0], pos_ax[..., 1]))

    null_vec = (align_vec.abs() <= 1e-5).all(dim=-1)
    neg = torch.where(null_vec, inf, torch.where(oob, nan, neg))
    pos = torch.where(null_vec, inf, torch.where(oob, nan, pos))
    return neg, pos
