"""DT3 feature map pieces (port of :mod:`openfdcm_tpu.matching.featuremap`).

The DT3 stack is one dense ``f32[S, depth, H, W]`` tensor: per orientation
slice the exact DT of that slice's scene lines, min-propagated across
orientations (kernel K3), then line-integrated along each slice's angle
(kernel K4).  Host-side numpy helpers are copied from the JAX package as
they are: their f32 op order is part of the numerics contract.

The single-scene API (:class:`Dt3Featuremap`, :func:`build_featuremap`,
:func:`evaluate`, :func:`save_featuremap` / :func:`load_featuremap`) sits
on the scene-batched build of :mod:`.pipeline`.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from ..core import draw
from ..core import geometry as geo
from ..core.dt import dt_from_indicator  # noqa: F401  (re-exported, as in JAX)
from ..core.rasterize import to_int_trunc
from ..core.types import Distance, F32_MAX, resolve_device
from ..ops.prop import propagate_orientation as k3_relax
from ..profiling import to_device


@dataclasses.dataclass(frozen=True)
class Dt3Params:
    """Reference ``Dt3CpuParameters`` (``dt3cpu.h:34-42``) + distance."""
    depth: int = 30
    dt3_coeff: float = 5.0
    padding: float = 2.2
    distance: Distance = Distance.L2


@dataclasses.dataclass
class Dt3Featuremap:
    """One scene's built feature map.

    ``dt3``: ``f32[depth, H, W]`` (the physical H/W may exceed the logical
    ``feature_size``; the logical region is reference-exact); ``angles``:
    ``f32[depth]`` ascending; ``scene_translation``: the shift applied to
    the scene (``dt3cpu.h:55-60``); ``feature_size``: logical ``(width,
    height)``, the reference ``Size``."""
    dt3: torch.Tensor
    angles: torch.Tensor
    scene_translation: torch.Tensor
    feature_size: tuple
    params: Dt3Params = dataclasses.field(default_factory=Dt3Params)

    @property
    def depth(self) -> int:
        return self.dt3.shape[0]

    def get_feature_size(self):
        return self.feature_size

    def get_scene_translation(self):
        return self.scene_translation


def save_featuremap(filepath: str, fm: Dt3Featuremap) -> None:
    """Write a feature map as ``.npz`` with the JAX package's keys, so
    either package reads the other's files."""
    np.savez_compressed(
        filepath,
        dt3=fm.dt3.cpu().numpy(), angles=fm.angles.cpu().numpy(),
        scene_translation=fm.scene_translation.cpu().numpy(),
        feature_size=np.asarray(fm.feature_size, np.int64),
        params=np.asarray([fm.params.depth, fm.params.dt3_coeff,
                           fm.params.padding, int(fm.params.distance)],
                          np.float64))


def load_featuremap(filepath: str, device="cuda") -> Dt3Featuremap:
    """Read a feature map written by :func:`save_featuremap` (of either
    package) onto ``device``."""
    device = resolve_device(device)
    z = np.load(filepath)
    p = z["params"]
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Dt3Featuremap(
        dt3=as_dev(z["dt3"]), angles=as_dev(z["angles"]),
        scene_translation=as_dev(z["scene_translation"]),
        feature_size=(int(z["feature_size"][0]), int(z["feature_size"][1])),
        params=Dt3Params(int(p[0]), float(p[1]), float(p[2]), Distance(int(p[3]))))


def empty_featuremap(params: Dt3Params = Dt3Params(), device="cuda") -> Dt3Featuremap:
    """The reference's empty-scene result (``dt3cpu.h:180-181``)."""
    device = resolve_device(device)
    return Dt3Featuremap(
        dt3=torch.zeros((0, 0, 0), dtype=torch.float32, device=device),
        angles=torch.zeros((0,), dtype=torch.float32, device=device),
        scene_translation=torch.zeros((2,), dtype=torch.float32, device=device),
        feature_size=(0, 0), params=params)


def build_featuremap(scene, params: Dt3Params = Dt3Params(),
                     pad_to: int | None = 128, device="cuda") -> Dt3Featuremap:
    """Build one scene's DT3 feature map on ``device`` (reference
    ``dt3cpu.h:174-234``), through the scene-batched build (kernels K2, K3,
    K4).  ``pad_to``: round the physical canvas up to a multiple of it
    (None: the logical size); the logical region does not depend on it."""
    from .pipeline import build_featuremap_batch
    device = resolve_device(device)
    arr = geo.as_lines_np(scene)
    if arr.shape[0] == 0:
        return empty_featuremap(params, device=device)
    return build_featuremap_batch([arr], params, pad_to=pad_to or 1,
                                  device=device).featuremap(0)


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


def closest_orientation_idx(angles, theta) -> torch.Tensor:
    """Index (int32) of the nearest angle of the ascending table ``angles``
    for each ``theta``, by the reference's ``std::map`` search
    (``dt3cpu.h:93-114``): an interior theta takes the closer of its two
    bracketing angles (ties to the upper); a theta beyond either end
    compares its circular distance to the first and the last angle (ties and
    NaN to the last).  The bracket is a compare-count over the small table,
    its angles gathered at clamped indices; no ``atan``.  On ``theta``'s
    device when it is a tensor, else on ``angles``'."""
    dev = theta.device if torch.is_tensor(theta) else (
        angles.device if torch.is_tensor(angles) else None)
    angles = to_device(angles, dev, torch.float32)
    theta = to_device(theta, dev, torch.float32)
    d = angles.shape[0]
    u = (angles <= theta[..., None]).sum(dim=-1)        # searchsorted 'right'
    interior = (u > 0) & (u < d)
    lo = torch.clamp(u - 1, 0, d - 1)
    hi = torch.clamp(u, 0, d - 1)
    pick_lo = (theta - angles[lo]).abs() < (theta - angles[hi]).abs()
    interior_idx = torch.where(pick_lo, lo, hi)
    a1 = theta - angles[0]
    a2 = theta - angles[d - 1]
    pick_first = (torch.minimum(a1, (a1 - math.pi).abs())
                  < torch.minimum(a2, (a2 - math.pi).abs()))
    boundary_idx = torch.where(pick_first, 0, d - 1)
    return torch.where(interior, interior_idx, boundary_idx).to(torch.int32)


def classify_lines(angles, lines: torch.Tensor) -> torch.Tensor:
    """Orientation-slice index per line (``(..., 4)`` -> ``(...)`` int32,
    as in the JAX package): nearest-angle semantics of ``theta =
    atan(dy/dx)`` evaluated in ratio space (``r = dy/dx``: ``sum(r >=
    splits)``, ``r >= wrap -> 0``, ``NaN -> depth-1``).  ``angles`` is the
    standard table ``make_angles(depth)``; only its length is read."""
    depth = len(angles)
    splits, wrap = orientation_ratio_splits(depth)
    sp = to_device(splits, lines.device, torch.float32)
    d = lines[..., 2:4] - lines[..., 0:2]
    r = d[..., 1] / d[..., 0]
    idx = (r[..., None] >= sp).sum(dim=-1, dtype=torch.int32)
    idx = torch.where(r >= wrap, 0, idx)
    return torch.where(torch.isnan(r), depth - 1, idx).to(torch.int32)


def propagation_weights(angles, coeff: float) -> np.ndarray:
    """Closed-form circular propagation weights ``Wmat[src, dst]`` (host
    numpy f32, copied from the JAX package): the min-plus closure of the
    reference's 1.5-cycle forward and backward relaxation
    (``dt3cpu.cpp:77-107``) over the cyclic slice graph with adjacent
    weights ``coeff * min(|da|, |da - pi|)``, the cheaper of the clockwise
    and counter-clockwise step sums, each accumulated in order in f32."""
    m = len(angles)
    a = np.asarray(angles, np.float32)
    step_fwd = np.empty(m, np.float32)  # weight of edge j -> (j+1) % m
    for j in range(m):
        h = np.abs(np.float32(a[j]) - np.float32(a[(j + 1) % m]))
        step_fwd[j] = np.float32(coeff) * np.minimum(h, np.abs(h - np.float32(math.pi)))
    wmat = np.zeros((m, m), np.float32)
    for src in range(m):
        cw = np.float32(0)
        cws = np.zeros(m, np.float32)
        for k in range(1, m):
            cw = np.float32(cw + step_fwd[(src + k - 1) % m])
            cws[(src + k) % m] = cw
        ccw = np.float32(0)
        ccws = np.zeros(m, np.float32)
        for k in range(1, m):
            ccw = np.float32(ccw + step_fwd[(src - k) % m])
            ccws[(src - k) % m] = ccw
        full = np.minimum(cws, ccws)
        full[src] = 0.0
        wmat[src] = full
    return wmat


def propagate_orientation(dt3: torch.Tensor, wmat) -> torch.Tensor:
    """Min-plus propagation across the orientation axis of ``dt3 (m, H,
    W)``: ``out[s] = min_src dt3[src] + wmat[src, s]``, a new tensor.  As
    the JAX package's scan over sources, a running elementwise minimum in
    one ``(m, H, W)`` carry (the adds and minima are exact, so their order
    does not change a bit).  Plain torch: the JAX package's version is an
    XLA scan, not a Pallas kernel."""
    w = torch.as_tensor(wmat, dtype=torch.float32, device=dt3.device)
    m = dt3.shape[0]
    out = torch.full_like(dt3, float("inf"))
    for src in range(m):
        for dst in range(m):
            torch.minimum(out[dst], dt3[src] + w[src, dst], out=out[dst])
    return out


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
    return k3_relax(dt3, steps)


def _indicator_batch(lines, line_mask, logical_hw, *, depth, phys_h, phys_w,
                     max_points):
    """Seed-indicator stack ``(S, depth, PH, PW)``: 0.0 at each line's
    rasterized seed pixels in its orientation slice, ``F32_MAX`` elsewhere.

    ``lines (S, N, 4)``, ``line_mask (S, N)`` and ``logical_hw (S, 2)``
    tensors.  Seeds outside the stack are dropped, as the JAX package's
    drop-mode scatter drops them."""
    s = lines.shape[0]
    slice_of_line = classify_lines(make_angles(depth), lines).to(torch.int64)
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


def minmax_translation(featuremap: Dt3Featuremap, tmpl: torch.Tensor,
                       align_vec: torch.Tensor, line_mask=None):
    """Legal ``(neg, pos)`` step multipliers of template lines ``tmpl (...,
    L, 4)`` along ``align_vec (..., 2)`` in ``featuremap``'s canvas
    (reference ``dt3cpu.cpp:30-75``); ``(inf, inf)`` for a null align
    vector, ``(nan, nan)`` when the template already leaves the image."""
    w, h = featuremap.feature_size
    if line_mask is None:
        line_mask = torch.ones(tmpl.shape[:-1], dtype=torch.bool,
                               device=tmpl.device)
    size = torch.tensor([float(w), float(h)], dtype=torch.float32,
                        device=tmpl.device)
    return minmax_translation_raw(tmpl, align_vec, size,
                                  featuremap.scene_translation.to(tmpl.device),
                                  line_mask)


def evaluate_batched(dt3_flat: torch.Tensor, hw: tuple, slice_idx: torch.Tensor,
                     endpoints: torch.Tensor, line_mask: torch.Tensor,
                     translations: torch.Tensor, take_fn=None) -> torch.Tensor:
    """FDCM scores of ``translations (..., K, 2)`` (scene translation
    included) for templates ``endpoints (..., L, 2, 2)`` with orientation
    slices ``slice_idx (..., L)`` and weights ``line_mask (..., L)``: per
    translation, the sum over lines, in line order, of ``|dt3[o, y2, x2] -
    dt3[o, y1, x1]|`` at int-truncated coordinates (reference
    ``dt3cpu.cpp:126-179``).  ``dt3_flat``: the flattened ``(D, H, W)``
    stack; probes are clamped to it as ``jnp.take(mode="clip")`` clamps.
    ``take_fn(dt3_flat, idx)``: an optional probe gather in place of the
    clamped one, given the unclamped flat indices ``(2, L, B*K)`` as in the
    JAX package (which must then clamp as it needs)."""
    h, w = hw
    lead = endpoints.shape[:-3]
    l, k = endpoints.shape[-3], translations.shape[-2]
    b = int(np.prod(lead)) if lead else 1
    ep = endpoints.reshape(b, l, 2, 2).permute(2, 1, 0, 3)          # (2, L, B, 2)
    tr = translations.reshape(b, k, 2)
    si = slice_idx.reshape(b, l).to(torch.int64)
    lm = line_mask.reshape(b, l).to(torch.float32)
    xi = to_int_trunc(ep[..., 0:1] + tr[..., 0])                    # (2, L, B, K)
    yi = to_int_trunc(ep[..., 1:2] + tr[..., 1])
    idx = (si.t() * (h * w))[None, :, :, None] + yi * w + xi
    if take_fn is None:
        vals = dt3_flat[idx.clamp(0, dt3_flat.numel() - 1)]
    else:
        vals = take_fn(dt3_flat, idx.reshape(2, l, b * k)).reshape(2, l, b, k)
    acc = torch.zeros((b, k), dtype=torch.float32, device=dt3_flat.device)
    for j in range(l):
        acc = acc + (vals[0, j] - vals[1, j]).abs() * lm[:, j:j + 1]
    return acc.reshape(*lead, k)


def evaluate(featuremap: Dt3Featuremap, templates, translations):
    """Reference-shaped entry (``featuremap.h:159``): a list of templates
    and a list of per-template translation lists -> a list of per-template
    score lists, on the feature map's device.  Extra templates or
    translation lists beyond the shorter input are dropped (zip)."""
    pairs = list(zip(templates, translations))
    if not pairs:
        return []
    dev = featuremap.dt3.device
    _, ph, pw = featuremap.dt3.shape
    tmpls = [geo.as_lines_np(t) for t, _ in pairs]
    trs_np = [np.asarray(tr, np.float32).reshape(-1, 2) for _, tr in pairs]
    n = len(tmpls)
    lmax = max(max(t.shape[0] for t in tmpls), 1)
    kmax = max(max(t.shape[0] for t in trs_np), 1)
    lines = np.zeros((n, lmax, 4), np.float32)
    mask = np.zeros((n, lmax), np.float32)
    trs = np.zeros((n, kmax, 2), np.float32)
    for i, (t, tr) in enumerate(zip(tmpls, trs_np)):
        lines[i, : t.shape[0]] = t
        mask[i, : t.shape[0]] = 1.0
        trs[i, : tr.shape[0]] = tr
    lines_d = torch.as_tensor(lines, device=dev)
    scores = evaluate_batched(
        featuremap.dt3.reshape(-1), (ph, pw),
        classify_lines(featuremap.angles, lines_d),
        lines_d.reshape(n, lmax, 2, 2), torch.as_tensor(mask, device=dev),
        torch.as_tensor(trs, device=dev) + featuremap.scene_translation)
    scores = scores.cpu().numpy()
    return [[float(x) for x in scores[i, : trs_np[i].shape[0]]]
            for i in range(n)]
