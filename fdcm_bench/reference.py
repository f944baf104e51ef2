"""Plain reference of FDCM matching, in NumPy and PyTorch.

A straightforward implementation of the matching that Innoptech/OpenFDCM
defines, written for the benchmark from the reference's semantics
(``dt3cpu.cpp``, ``defaultsearch.cpp``, ``defaultmatch.cpp``,
``batchoptimize.cpp``, ``exponentialpenalty.cpp``): each scene's DT3
feature map on its logical canvas (seed pixels per orientation, the exact
Euclidean distance transform by brute force over each row, the
orientation relaxation, the directional line integrals), the DefaultSearch
pairs, both aligning transforms of every pair, the BatchOptimize walks,
the exponential penalty and the top-k.  It imports nothing of the program
under test and takes nothing it made: it works from the lines alone.

Every operation is rounded in the reference's order, in float32 as the
configuration states.  ``dtype`` (the control passes bfloat16) sets the
precision of the feature map's values and of the scores, the walks'
comparisons and the penalty; geometry (canvas, angles, sweep deltas, line
classes, pair windows, transforms, steps) stays float32.  A square root is taken in
float64 and rounded, which is the correctly rounded float32 root.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

F32 = np.float32
F32_MAX = float(np.finfo(np.float32).max)
BIG = 3.0e38
# rows of the distance transform's brute-force row pass held at once
ROW_BLOCK = 32


@dataclass(frozen=True)
class Setting:
    """What the configuration states about the matching."""
    depth: int
    coeff: float
    padding: float
    max_tmpl_lines: int
    max_scene_lines: int
    batch_size: int
    tau: float
    top_k: int

    @classmethod
    def of(cls, config: dict) -> "Setting":
        m = config["matching"]
        if m["distance"] != "L2":
            raise ValueError("the reference computes the L2 distance only")
        return cls(int(m["depth"]), float(m["dt3_coeff"]), float(m["padding"]),
                   int(m["max_tmpl_lines"]), int(m["max_scene_lines"]),
                   int(m["batch_size"]), float(m["penalty_tau"]),
                   int(m["top_k"]))


# ---------------------------------------------------------------------------
# host geometry
# ---------------------------------------------------------------------------

def canvas(scene: np.ndarray, padding: float):
    """``(translation (2,), (w, h))`` of a scene (``dt3cpu.cpp:109-116``)."""
    pts = np.asarray(scene, F32).reshape(-1, 2)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    required = F32(max(1.0, padding)) * F32((hi - lo).max()) * np.ones(2, F32)
    tr = required / F32(2) - (hi + lo) / F32(2)
    size = np.ceil(required + F32(1)).astype(np.int64)
    return tr.astype(F32), (int(size[0]), int(size[1]))


def angles_of(depth: int) -> np.ndarray:
    i = np.arange(depth, dtype=F32)
    return (i * F32(math.pi) / F32(depth) - F32(math.pi / 2)).astype(F32)


def orientation(angles: np.ndarray, lines: np.ndarray) -> np.ndarray:
    """Nearest angle of each line's ``atan(dy/dx)`` (``dt3cpu.h:93-114``):
    an interior angle takes the closer of its two neighbours (ties to the
    upper), one beyond the ends the closer end by circular distance."""
    d = lines[..., 2:4] - lines[..., 0:2]
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = np.arctan(d[..., 1] / d[..., 0]).astype(F32)
    n = len(angles)
    u = np.searchsorted(angles, theta, side="right")
    lo, hi = np.clip(u - 1, 0, n - 1), np.clip(u, 0, n - 1)
    inner = np.where(np.abs(theta - angles[lo]) < np.abs(theta - angles[hi]), lo, hi)
    a1, a2 = theta - angles[0], theta - angles[n - 1]
    first = (np.minimum(a1, np.abs(a1 - F32(np.pi)))
             < np.minimum(a2, np.abs(a2 - F32(np.pi))))
    edge = np.where(first, 0, n - 1)
    return np.where((u > 0) & (u < n), inner, edge).astype(np.int64)


def relaxation_steps(angles: np.ndarray, coeff: float):
    """``(src, dst, weight)`` of the relaxation: 1.5 cycles forward, then
    1.5 backward (``dt3cpu.cpp:77-107``)."""
    m = len(angles)
    out = []

    def add(c, step):
        c1, c2 = (m + ((c - step) % m)) % m, (m + (c % m)) % m
        h = F32(abs(F32(angles[c1]) - F32(angles[c2])))
        out.append((c1, c2, F32(coeff) * np.minimum(h, np.abs(h - F32(math.pi)))))

    for c in range(int(math.ceil(1.5 * m))):
        add(c, 1)
    c, end = m, -int(math.floor(1.5 * m))
    while c != end:
        add(c, -1)
        c -= 1
    return out


def sweep_of(angle) -> tuple:
    """``(x_major, flip, r)`` of the line integral along ``angle``
    (``imgproc.h:42-57``)."""
    c, s = F32(np.cos(F32(angle))), F32(np.sin(F32(angle)))
    tan = s / c
    if -1.0 <= tan < 1.0:
        neg = c < 0
        v = (F32(1 - 2 * neg), F32(tan - 2.0 * neg * tan))
        return True, float(v[0]) < 0, v[1]
    neg = s < 0
    inv = F32(1.0) / tan
    v = (F32(inv - 2.0 * neg * inv), F32(1 - 2 * neg))
    return False, float(v[1]) < 0, v[0]


def sweep_deltas(r, n: int) -> np.ndarray:
    """``round(i r) - round((i - 1) r)`` with ``std::round``; 0 first."""
    p = np.arange(n, dtype=F32) * F32(r)
    s = (np.sign(p) * np.floor(np.abs(p) + F32(0.5))).astype(np.int64)
    d = np.zeros(n, np.int64)
    d[1:] = s[1:] - s[:-1]
    return d


def line_lengths(lines: np.ndarray) -> np.ndarray:
    d = lines[:, 2:4] - lines[:, 0:2]
    return np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2).astype(F32)


def template_length(lines: np.ndarray) -> F32:
    return F32(np.sum(line_lengths(lines), dtype=F32))


def default_search_pairs(templates, scene: np.ndarray, mt: int, ms: int):
    """DefaultSearch (``defaultsearch.cpp:29-49``): each of a template's
    ``mt`` longest lines (stable) with the window of ``ms`` scene lines
    centred on the closest in length (``binarySearch``, ties to the
    longer).  ``(P, 3)`` rows ``(template, template line, scene line)`` in
    emplace order."""
    slen = line_lengths(scene)
    order = np.argsort(-slen, kind="stable")
    ssl = slen[order]
    n = len(ssl)
    rows = []
    for t, tl in enumerate(templates):
        tlen = line_lengths(tl)
        for line in np.argsort(-tlen, kind="stable")[:min(mt, len(tlen))]:
            v = tlen[line]
            i = int(np.searchsorted(-ssl, -v, side="left"))
            if i == 0:
                c = 0
            elif i == n:
                c = n - 1
            else:
                c = i if abs(v - ssl[i]) < abs(v - ssl[i - 1]) else i - 1
            b = max(0, c - ms // 2)
            e = min(b + ms, n)
            b = max(0, e - ms)
            rows += [(t, int(line), int(order[k])) for k in range(b, e)]
    return np.asarray(rows, np.int64).reshape(-1, 3)


# ---------------------------------------------------------------------------
# the DT3 feature map
# ---------------------------------------------------------------------------

def fma(a, b, c):
    """``a * b + c`` rounded once to float32: the product is exact in
    float64, TwoSum gives the sum's error, and the sum rounded to odd
    before the float32 rounding makes the double rounding exact."""
    p = a.double() * b.double()
    s = p + c.double()
    bb = s - p
    err = (p - (s - bb)) + (c.double() - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def clip(lines: torch.Tensor, w: int, h: int):
    """Cohen-Sutherland clip to ``[0, w-1] x [0, h-1]`` (``drawing.cpp:29-112``):
    ``(lines, kept)``."""
    x0, x1, y0, y1 = 0.0, float(w - 1), 0.0, float(h - 1)

    def code(x, y):
        c = torch.where(x < x0, 1, torch.where(x > x1, 2, 0))
        return c | torch.where(y < y0, 4, torch.where(y > y1, 8, 0))

    def move(px, py, qx, qy, cd):
        top, bottom = (cd & 8) != 0, (cd & 4) != 0
        right, left = (cd & 2) != 0, (cd & 1) != 0
        bottom, right, left = bottom & ~top, right & ~top & ~bottom, left & ~top & ~bottom & ~right
        yc = torch.where(top, y1, y0)
        xc = torch.where(right, x1, x0)
        nx = px + (qx - px) * (yc - py) / (qy - py)
        ny = py + (qy - py) * (xc - px) / (qx - px)
        vert, horiz = top | bottom, right | left
        return (torch.where(vert, nx, torch.where(horiz, xc, px)),
                torch.where(vert, yc, torch.where(horiz, ny, py)))

    ax, ay, bx, by = lines.unbind(-1)
    keep = torch.zeros(ax.shape, dtype=torch.bool, device=lines.device)
    gone = torch.zeros_like(keep)
    for _ in range(8):
        ca, cb = code(ax, ay), code(bx, by)
        live = ~(keep | gone)
        inside, apart = (ca == 0) & (cb == 0), (ca & cb) != 0
        keep |= live & inside
        gone |= live & apart
        live &= ~inside & ~apart
        na, nb = move(ax, ay, bx, by, ca), move(bx, by, ax, ay, cb)
        first, second = live & (ca != 0), live & (ca == 0)
        ax, ay = torch.where(first, na[0], ax), torch.where(first, na[1], ay)
        bx, by = torch.where(second, nb[0], bx), torch.where(second, nb[1], by)
    return torch.stack([ax, ay, bx, by], dim=-1), keep


def seeds(lines: torch.Tensor, w: int, h: int):
    """Rasterized pixels ``(x, y)`` of each clipped line and their mask
    (``drawing.h:57-125``): point ``i`` is ``round(p1 + i (p2 - p1) / (n -
    1))`` over ``n = trunc(max(|dx|, |dy|)) + 1`` points, product and sum
    fused; a line shorter than 1e-5 in both axes is one point."""
    lines, kept = clip(lines, w, h)
    a, d = lines[:, 0:2], lines[:, 2:4] - lines[:, 0:2]
    ext = torch.maximum(d[:, 0].abs(), d[:, 1].abs())
    size = torch.trunc(torch.nan_to_num(ext.double(), nan=0.0).clamp(0, 2.0 ** 31 - 2)) + 1
    point = (d.abs() <= 1e-5).all(dim=1)
    size = torch.where(point, torch.ones_like(size), size).long()
    p = int(size.max()) if size.numel() else 1
    i = torch.arange(p, dtype=torch.float32, device=lines.device)
    frac = i[None, :] / torch.clamp_min(size - 1, 1).float()[:, None]
    pts = fma(d[:, None, :], frac[..., None], a[:, None, :])
    pts = torch.where((size == 1)[:, None, None],
                      torch.where(point[:, None], a, lines[:, 2:4])[:, None, :], pts)
    pts = (torch.sign(pts) * torch.floor(pts.abs() + 0.5)).long()
    mask = (i[None, :] < size[:, None].float()) & kept[:, None]
    return pts, mask


def column_distance(ind: torch.Tensor) -> torch.Tensor:
    """Distance in rows to the nearest seed of the same column, F32_MAX in
    a column without one; ``ind (D, H, W)`` bool."""
    h = ind.shape[1]
    y = torch.arange(h, device=ind.device)[None, :, None]
    up = torch.cummax(torch.where(ind, y, -(2 ** 40)), dim=1).values
    down = torch.flip(torch.cummin(torch.flip(torch.where(ind, y, 2 ** 40), (1,)),
                                   dim=1).values, (1,))
    g = torch.minimum(y - up, down - y)
    return torch.where(g < h, g.double(), F32_MAX)


def distance(ind: torch.Tensor, dtype) -> torch.Tensor:
    """Exact L2 distance to the nearest seed per slice ``(D, H, W)``:
    ``min_s g[y, s]² + (x - s)²`` over the whole row, then the root; no
    seed in a slice: F32_MAX."""
    d, h, w = ind.shape
    g = column_distance(ind).to(dtype).reshape(d * h, w)
    g2 = g * g                                   # F32_MAX² is inf
    xs = torch.arange(w, device=ind.device)
    dx2 = ((xs[:, None] - xs[None, :]) ** 2).to(dtype)      # (x, s)
    out = torch.empty_like(g)
    for r in range(0, d * h, ROW_BLOCK):
        out[r:r + ROW_BLOCK] = (g2[r:r + ROW_BLOCK, None, :] + dx2[None]).amin(dim=2)
    top = torch.finfo(dtype).max                 # F32_MAX in float32
    out = torch.clamp_max(out, top)
    root = torch.sqrt(out.double()).to(dtype)
    return torch.where(out >= top, out, root).reshape(d, h, w)


def integrate(imgs: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Prefix sums of ``imgs (G, R, N)`` along N, each step's carry shifted
    by its slice's row delta (-1, 0 or +1, ``deltas (G, N)``) with zero fill
    (``imgproc.h:38-84``): one add a pixel, in path order."""
    out = torch.empty_like(imgs)
    carry = torch.zeros_like(imgs[:, :, 0])
    zero = carry[:, :1]
    for c in range(imgs.shape[2]):
        d = deltas[:, c, None]
        down = torch.cat([zero, carry[:, :-1]], dim=1)
        up = torch.cat([carry[:, 1:], zero], dim=1)
        carry = imgs[:, :, c] + torch.where(d == 1, down, torch.where(d == -1, up, carry))
        out[:, :, c] = carry
    return out


def featuremap(scene: np.ndarray, s: Setting, device, dtype=torch.float32):
    """The DT3 line-integral stack of one scene on its logical canvas:
    ``(stack (D, h, w), translation (2,), (w, h))``."""
    tr, (w, h) = canvas(scene, s.padding)
    angles = angles_of(s.depth)
    lines = np.asarray(scene, F32) + np.concatenate([tr, tr])
    cls = orientation(angles, lines)
    pts, mask = seeds(torch.as_tensor(lines, device=device), w, h)
    x, y = pts[..., 0], pts[..., 1]
    mask &= (x >= 0) & (x < w) & (y >= 0) & (y < h)
    slot = torch.as_tensor(cls, device=device)[:, None].expand_as(x)
    ind = torch.zeros((s.depth, h, w), dtype=torch.bool, device=device)
    ind[slot[mask], y[mask], x[mask]] = True
    dt = distance(ind, dtype)
    del ind
    for c1, c2, wgt in relaxation_steps(angles, s.coeff):
        torch.minimum(dt[c2], dt[c1] + torch.tensor(float(wgt), dtype=dtype,
                                                   device=device), out=dt[c2])
    groups = {}
    for j, angle in enumerate(angles):
        x_major, flip, r = sweep_of(angle)
        groups.setdefault((x_major, flip), []).append((j, r))
    for (x_major, flip), members in groups.items():
        idx = torch.as_tensor([j for j, _ in members], device=device)
        imgs = dt[idx] if x_major else dt[idx].transpose(1, 2)
        n = imgs.shape[2]
        deltas = torch.as_tensor(np.stack([sweep_deltas(r, n) for _, r in members]),
                                 device=device)
        if flip:        # a reversed sweep, its k-th column taking delta k
            imgs = torch.flip(imgs, (2,))
        li = integrate(imgs, deltas)
        if flip:
            li = torch.flip(li, (2,))
        dt[idx] = li if x_major else li.transpose(1, 2)
    return dt, tr, (w, h)


# ---------------------------------------------------------------------------
# candidates, walks, ranking
# ---------------------------------------------------------------------------

def unit(lines: torch.Tensor) -> torch.Tensor:
    d = lines[..., 2:4] - lines[..., 0:2]
    n = torch.sqrt((d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2]).double()).to(d.dtype)
    return torch.where(n > 0, d / torch.where(n > 0, n, torch.ones_like(n)),
                       torch.zeros_like(d))


def rotate(rot, v):
    return torch.stack([rot[..., 0, 0] * v[..., 0] + rot[..., 0, 1] * v[..., 1],
                        rot[..., 1, 0] * v[..., 0] + rot[..., 1, 1] * v[..., 1]], dim=-1)


def aligning(t_line, s_line):
    """Both rigid transforms ``(C, 2, 2, 3)`` taking the template line onto
    the scene line (``math.h:387-406``)."""
    td, sd = unit(t_line), unit(s_line)
    cos = sd[..., 0] * td[..., 0] + sd[..., 1] * td[..., 1]
    sin = sd[..., 1] * td[..., 0] - sd[..., 0] * td[..., 1]
    ct = (t_line[..., 0:2] + t_line[..., 2:4]) * 0.5
    cs = (s_line[..., 0:2] + s_line[..., 2:4]) * 0.5
    mats = []
    for c, s in ((cos, sin), (-cos, -sin)):
        rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
        mats.append(torch.cat([rot, (cs - rotate(rot, ct))[..., None]], dim=-1))
    return torch.stack(mats, dim=1)


def step_vector(v):
    """The alignment vector scaled so its larger component is +-1
    (``drawing.h:57-67``)."""
    vx, vy = v[..., 0], v[..., 1]
    tan = vy / vx
    c1, c2 = (vx < 0).to(v.dtype), (vy < 0).to(v.dtype)
    inv = 1.0 / tan
    r1 = torch.stack([1.0 - 2.0 * c1, tan - 2.0 * c1 * tan], -1)
    r2 = torch.stack([inv - 2.0 * c2 * inv, 1.0 - 2.0 * c2], -1)
    return torch.where(((tan >= -1.0) & (tan < 1.0))[..., None], r1, r2)


def step_range(lines, mask, v, size, tr):
    """Legal step multipliers ``(neg, pos)`` of each candidate along ``v``
    (``dt3cpu.cpp:30-75``): inf for a null vector, NaN when the template
    already leaves the canvas."""
    pts = lines.reshape(*lines.shape[:-1], 2, 2)
    m = mask[..., None, None]
    lo = torch.where(m, pts, math.inf).amin(dim=(-3, -2)) + tr
    hi = torch.where(m, pts, -math.inf).amax(dim=(-3, -2)) + tr
    out = ((size - 1 - hi) < 0).any(-1) | (lo < 0).any(-1)
    mult = torch.stack([-hi, -lo, size - hi - 1.0, size - lo - 1.0], -1) / v[..., None]
    neg_side = torch.signbit(mult)
    negs = torch.where(neg_side, mult, -math.inf)
    poss = torch.where(neg_side, math.inf, mult)
    neg_ax = torch.where(negs.isnan().any(-1), math.nan, negs.amax(-1))
    pos_ax = torch.where(poss.isnan().any(-1), math.nan, poss.amin(-1))
    both = neg_ax.isfinite().all(-1) & pos_ax.isfinite().all(-1)
    x_ok = neg_ax[..., 0].isfinite() & pos_ax[..., 0].isfinite()
    neg = torch.where(both, neg_ax.amax(-1), torch.where(x_ok, neg_ax[..., 0], neg_ax[..., 1]))
    pos = torch.where(both, pos_ax.amin(-1), torch.where(x_ok, pos_ax[..., 0], pos_ax[..., 1]))
    null = (v.abs() <= 1e-5).all(-1)
    nan = torch.full_like(neg, math.nan)
    neg = torch.where(null, math.inf, torch.where(out, nan, neg))
    pos = torch.where(null, math.inf, torch.where(out, nan, pos))
    return neg, pos


class Scorer:
    """FDCM scores of candidates at step multipliers (``dt3cpu.cpp:126-179``):
    per step the translation ``scene_tr + m v``, each line's endpoints
    int-truncated, and the sum over lines, in line order, of ``|LI[p1] -
    LI[p2]|`` in the line's orientation slice."""

    def __init__(self, li, lines, mask, cls, tr):
        self.flat = li.reshape(-1)
        self.h, self.w = li.shape[1:]
        self.lines, self.mask, self.tr = lines, mask, tr
        self.base = cls * (self.h * self.w)                   # (C, L)

    def __call__(self, sel, m, v):
        """Scores ``(len(sel), K)`` at multipliers ``m (len(sel), K)``."""
        dt = self.flat.dtype
        trx = self.tr[0] + m * v[:, 0:1]
        tr_y = self.tr[1] + m * v[:, 1:2]
        lines, mask, base = self.lines[sel], self.mask[sel], self.base[sel]
        acc = torch.zeros(m.shape, dtype=dt, device=m.device)
        for j in range(lines.shape[1]):
            ends = []
            for ix, iy in ((0, 1), (2, 3)):
                x = torch.trunc(lines[:, j, ix:ix + 1] + trx).long()
                y = torch.trunc(lines[:, j, iy:iy + 1] + tr_y).long()
                idx = (base[:, j:j + 1] + y * self.w + x).clamp(0, self.flat.numel() - 1)
                ends.append(self.flat[idx])
            term = (ends[0] - ends[1]).abs()
            acc = torch.where(mask[:, j:j + 1], acc + term, acc)
        return acc


def walk(score, s0, t_pos, t_neg, v, batch):
    """BatchOptimize (``batchoptimize.cpp:48-94``) on every candidate at
    once: batches of ``batch`` steps away from the aligned position, first
    towards +v, then -v; a batch whose minimum rises above the last kept
    score ends the direction before it is kept, one whose minimum is not
    its last step after.  Returns the best kept score and its multiplier."""
    prev, best = s0.clone(), s0.clone()
    mul = torch.zeros_like(t_pos)
    lanes = torch.arange(batch, dtype=t_pos.dtype, device=s0.device)
    for sign, limit in ((1.0, t_pos), (-1.0, t_neg)):
        t0 = torch.ones_like(t_pos)
        live = limit >= 1
        while bool(live.any()):
            sel = live.nonzero()[:, 0]
            steps = t0[sel, None] + lanes[None, :]
            legal = steps <= limit[sel, None]
            sc = torch.where(legal, score(sel, sign * steps, v[sel]), BIG)
            bmin = sc.amin(dim=1)
            barg = (torch.where(sc == bmin[:, None], lanes, math.inf)).amin(dim=1)
            last = torch.gather(sc, 1, (legal.sum(dim=1) - 1)[:, None])[:, 0]
            keep = ~(bmin > prev[sel])
            better = keep & (bmin < best[sel])
            best[sel] = torch.where(better, bmin, best[sel])
            mul[sel] = torch.where(better, sign * (t0[sel] + barg), mul[sel])
            prev[sel] = torch.where(keep, bmin, prev[sel])
            end = ~keep | (keep & (bmin < last)) | (t0[sel] + batch > limit[sel])
            t0[sel] += batch
            live[sel] = ~end
    return best, mul


@dataclass
class Row:
    """One match: penalized score, template and its 2 x 3 transform."""
    score: float
    template: int
    transform: np.ndarray


def match(li, tr, size, templates, scene: np.ndarray, s: Setting, device,
          dtype=torch.float32, keep: int | None = None):
    """Ranked matches of ``templates`` (host ``(N_i, 4)`` arrays) in one
    scene against its stack ``li``: the valid candidates penalized and
    ordered by (score, candidate index), the first ``keep`` (default
    ``top_k``) of them."""
    keep = s.top_k if keep is None else keep
    pairs = default_search_pairs(templates, scene, s.max_tmpl_lines,
                                 s.max_scene_lines)
    if pairs.shape[0] == 0:
        return []
    lmax = max(t.shape[0] for t in templates)
    bank = np.zeros((len(templates), lmax, 4), F32)
    bmask = np.zeros((len(templates), lmax), bool)
    for i, t in enumerate(templates):
        bank[i, :t.shape[0]], bmask[i, :t.shape[0]] = t, True
    as_dev = lambda a: torch.as_tensor(a, device=device)
    bank_d = as_dev(bank)
    scene_d = as_dev(np.asarray(scene, F32))
    t_idx = np.repeat(pairs[:, 0], 2)                          # (C,)
    t_line = bank_d[as_dev(pairs[:, 0]), as_dev(pairs[:, 1])]
    s_line = scene_d[as_dev(pairs[:, 2])]
    mats = aligning(t_line, s_line).reshape(-1, 2, 3)           # (C, 2, 3)
    v = unit(s_line).repeat_interleave(2, dim=0)
    tl = bank_d[as_dev(t_idx)]                                  # (C, L, 4)
    rot, off = mats[:, None, :, :2], mats[:, None, :, 2]
    lines = torch.cat([rotate(rot, tl[..., 0:2]) + off,
                       rotate(rot, tl[..., 2:4]) + off], dim=-1)
    mask = as_dev(bmask)[as_dev(t_idx)]
    angles = angles_of(s.depth)
    cls = np.where(bmask[t_idx], orientation(angles, lines.float().cpu().numpy()), 0)
    null = (v.abs().sum(-1) - 0.0).abs() <= 1.1920929e-07
    step = step_vector(v)
    size_d = torch.tensor([float(size[0]), float(size[1])], device=device)
    tr_d = as_dev(tr)
    neg, pos = step_range(lines, mask, step, size_d, tr_d)
    valid = neg.isfinite() & pos.isfinite() & ~null
    step = torch.where(valid[:, None], step, 0.0)
    t_pos = torch.where(valid, torch.trunc(torch.where(valid, pos, 0.0)), 0.0)
    t_neg = torch.where(valid, torch.trunc(torch.where(valid, -neg, 0.0)), 0.0)
    score = Scorer(li, lines, mask & valid[:, None], as_dev(cls), tr_d)
    every = torch.arange(lines.shape[0], device=device)
    s0 = score(every, torch.zeros((lines.shape[0], 1), device=device), step)[:, 0]
    best, mul = walk(score, s0, t_pos, t_neg, step, s.batch_size)
    mats = mats.clone()
    mats[..., 2] += mul[:, None] * step
    lengths = np.asarray([template_length(t) for t in templates], F32)
    power = torch.pow(torch.clamp_min(as_dev(lengths)[as_dev(t_idx)], 1e-6).double(),
                      float(F32(s.tau))).to(dtype)
    pen = torch.where(valid, best / power, math.inf)
    order = torch.sort(pen.float(), stable=True).indices[:keep]
    pen, mats = pen.float().cpu().numpy(), mats.float().cpu().numpy()
    return [Row(float(pen[i]), int(t_idx[i]), mats[i].copy())
            for i in order.cpu().numpy() if np.isfinite(pen[i])]
