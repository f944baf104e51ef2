"""Frozen copy of the repository's numpy oracle (tests/oracle.py) as it stood when the
benchmark was written, kept here so that the benchmark's reference is held
to it without importing the program's test helpers."""
from __future__ import annotations

import numpy as np

F32 = np.float32


def closest_orientation_idx(angles: np.ndarray, theta: float) -> int:
    """Reference ``dt3cpu.h:93-114`` (map lower_bound semantics)."""
    d = len(angles)
    u = int(np.searchsorted(angles, theta, side="right"))
    if 0 < u < d:
        lo, hi = u - 1, u
        return lo if abs(theta - angles[lo]) < abs(theta - angles[hi]) else hi
    a1 = theta - angles[0]
    a2 = theta - angles[d - 1]
    if min(a1, abs(a1 - np.pi)) < min(a2, abs(a2 - np.pi)):
        return 0
    return d - 1


def evaluate(dt3: np.ndarray, angles: np.ndarray, scene_tr: np.ndarray,
             tmpl: np.ndarray, translations) -> list:
    """Score one template at each translation (``dt3cpu.cpp:126-179``).

    ``dt3``: (depth, H, W) logical images; ``tmpl``: (L, 4) f32;
    ``translations``: list of (2,) — WITHOUT the scene translation.
    """
    tmpl = np.asarray(tmpl, F32)
    d = tmpl[:, 2:4] - tmpl[:, 0:2]
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = np.arctan(d[:, 1] / d[:, 0]).astype(F32)
    o = [closest_orientation_idx(angles, float(t)) for t in theta]
    out = []
    for tr in translations:
        trans = (np.asarray(scene_tr, F32) + np.asarray(tr, F32)).astype(F32)
        score = F32(0)
        for l in range(tmpl.shape[0]):
            p1 = (tmpl[l, 0:2] + trans).astype(np.int32)
            p2 = (tmpl[l, 2:4] + trans).astype(np.int32)
            v1 = dt3[o[l], p1[1], p1[0]]
            v2 = dt3[o[l], p2[1], p2[0]]
            score = F32(score + np.abs(F32(v1) - F32(v2)))
        out.append(float(score))
    return out


def rasterize_vector(v: np.ndarray) -> np.ndarray:
    """Reference ``drawing.h:57-67`` in f32."""
    vx, vy = F32(v[0]), F32(v[1])
    tan = vy / vx
    if -1.0 <= tan < 1.0:
        cond = vx < 0
        return np.array([F32(1 - 2 * cond), F32(tan - 2 * cond * tan)], F32)
    cond = vy < 0
    inv = F32(1.0) / tan
    return np.array([F32(inv - 2 * cond * inv), F32(1 - 2 * cond)], F32)


def minmax_translation(tmpl: np.ndarray, align_vec: np.ndarray, size_wh,
                       scene_tr) -> tuple:
    """Reference ``dt3cpu.cpp:30-75`` (vectorized closed form, f32)."""
    pts = np.asarray(tmpl, F32).reshape(-1, 2) + np.asarray(scene_tr, F32)
    min_pt = pts.min(axis=0)
    max_pt = pts.max(axis=0)
    size = np.asarray(size_wh, F32)
    if np.any(size - 1 - max_pt < 0) or np.any(min_pt < 0):
        return np.nan, np.nan
    if np.all(np.abs(align_vec) <= 1e-5):
        return np.inf, np.inf
    mult = np.stack([-max_pt, -min_pt, size - max_pt - 1, size - min_pt - 1])
    with np.errstate(divide="ignore", invalid="ignore"):
        mult = mult / np.asarray(align_vec, F32)[None, :]
    neg_ax, pos_ax = [], []
    for ax in range(2):
        col = mult[:, ax]
        negs = col[np.signbit(col)]
        poss = col[~np.signbit(col)]
        neg_ax.append(np.max(negs) if negs.size else -np.inf)
        pos_ax.append(np.min(poss) if poss.size else np.inf)
    neg_ax, pos_ax = np.asarray(neg_ax), np.asarray(pos_ax)
    finite = np.isfinite(neg_ax) & np.isfinite(pos_ax)
    if finite.all():
        return float(np.max(neg_ax)), float(np.min(pos_ax))
    if finite[0]:
        return float(neg_ax[0]), float(pos_ax[0])
    return float(neg_ax[1]), float(pos_ax[1])


def default_optimize(dt3, angles, scene_tr, size_wh, tmpl, align_vec):
    """Reference DefaultOptimize walk (``defaultoptimize.cpp:15-69``).

    Returns ``None`` or ``(score, translation, n_evals)``.
    """
    if np.isclose(np.abs(np.asarray(align_vec, F32)).sum(), 0.0, atol=1.1920929e-07):
        return None
    rast = rasterize_vector(align_vec)
    min_mul, max_mul = minmax_translation(tmpl, rast, size_wh, scene_tr)
    if not (np.isfinite(min_mul) and np.isfinite(max_mul)):
        return None
    translations = [np.zeros(2, F32)]
    scores = [evaluate(dt3, angles, scene_tr, tmpl, [translations[0]])[0]]
    n = 1
    for mul in range(1, int(max_mul) + 1):
        tr = F32(mul) * rast
        s = evaluate(dt3, angles, scene_tr, tmpl, [tr])[0]
        n += 1
        if s > scores[-1]:
            break
        translations.append(tr)
        scores.append(s)
    for mul in range(-1, int(min_mul) - 1, -1):
        tr = F32(mul) * rast
        s = evaluate(dt3, angles, scene_tr, tmpl, [tr])[0]
        n += 1
        if s > scores[-1]:
            break
        translations.append(tr)
        scores.append(s)
    best = int(np.argmin(scores))
    return scores[best], translations[best], n


def batch_optimize(dt3, angles, scene_tr, size_wh, tmpl, align_vec, batch_size):
    """Reference BatchOptimize walk (``batchoptimize.cpp:48-94``)."""
    if np.isclose(np.abs(np.asarray(align_vec, F32)).sum(), 0.0, atol=1.1920929e-07):
        return None
    rast = rasterize_vector(align_vec)
    min_mul, max_mul = minmax_translation(tmpl, rast, size_wh, scene_tr)
    if not (np.isfinite(min_mul) and np.isfinite(max_mul)):
        return None
    translations = [np.zeros(2, F32)]
    scores = [evaluate(dt3, angles, scene_tr, tmpl, [translations[0]])[0]]

    def run_batches(muls):
        for i in range(0, len(muls), batch_size):
            chunk = muls[i: i + batch_size]
            trs = [F32(m) * rast for m in chunk]
            ss = evaluate(dt3, angles, scene_tr, tmpl, trs)
            bi = int(np.argmin(ss))
            if ss[bi] > scores[-1]:
                return
            scores.append(ss[bi])
            translations.append(trs[bi])
            if ss[bi] < ss[-1]:
                return

    run_batches(list(range(1, int(max_mul) + 1)))
    run_batches(list(range(-1, int(min_mul) - 1, -1)))
    best = int(np.argmin(scores))
    return scores[best], translations[best]
