"""Directional line integrals (port of :mod:`openfdcm_tpu.core.integral`).

Each DT3 slice is prefix-summed along its own angle: sweeping the major
axis, each position adds the previous carry shifted by
``delta_i = round(i*r) - round((i-1)*r)`` rows (reference
``core/imgproc.h:38-84``).  The sweep runs on kernel K4
(:mod:`openfdcm_tpu_torch.ops.integral`).  Physical canvases may be padded
beyond each scene's logical region; padded cells are zero and the sweep
geometry keeps the logical region reference-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.integral import sweep_scan


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


def _group_geometry(angles, phys_n_by_major):
    """Static per-group geometry: for each major-axis group, the member slice
    indices, flip flags, and delta tables."""
    specs = [sweep_spec(float(a)) for a in angles]
    groups = []
    for want_x_major in (True, False):
        idxs = [i for i, sp in enumerate(specs) if sp[0] == want_x_major]
        if not idxs:
            continue
        n_phys = phys_n_by_major[want_x_major]
        flips = np.array([specs[i][1] for i in idxs])
        dels = np.stack([_deltas(specs[i][2], n_phys) for i in idxs])
        groups.append((want_x_major, tuple(idxs), flips, dels))
    return groups


def line_integral_stack(imgs: torch.Tensor, angles, logical_hw) -> torch.Tensor:
    """Line integrals of a scene batch ``(S, D, PH, PW)``, one static angle
    per slice.  ``logical_hw``: host ``(S, 2)`` ints ``(H, W)``; each scene's
    padding beyond it must be zero.

    A flipped sweep is a reversed sweep over the physical axis whose column
    ``c`` takes the delta of sweep position ``n_log - 1 - c`` (0 in the
    padding), as in the JAX package."""
    s, d, ph, pw = imgs.shape
    logical_hw = np.asarray(logical_hw, np.int64).reshape(s, 2)
    out = torch.empty_like(imgs)
    for x_major, idxs, flips, dels in _group_geometry(angles, {True: pw, False: ph}):
        n_log = logical_hw[:, 1] if x_major else logical_hw[:, 0]     # (S,)
        for flip in (False, True):
            sub = [k for k, f in enumerate(flips) if bool(f) == flip]
            if not sub:
                continue
            sub_idxs = [idxs[k] for k in sub]
            dsub = dels[np.asarray(sub)]                               # (G, n)
            n_phys = dsub.shape[1]
            if flip:
                col = np.arange(n_phys)
                pidx = np.clip(n_log[:, None] - 1 - col[None, :], 0, n_phys - 1)
                dcol = np.where(col[None, None, :] < n_log[:, None, None],
                                dsub[:, pidx].transpose(1, 0, 2), 0)   # (S, G, n)
            else:
                dcol = np.broadcast_to(dsub[None], (s,) + dsub.shape)
            sel = torch.as_tensor(sub_idxs, device=imgs.device)
            group = imgs[:, sel].reshape(-1, ph, pw)
            dev_d = torch.as_tensor(np.array(dcol, np.int32, order="C").reshape(-1, n_phys),
                                    device=imgs.device)
            res = sweep_scan(group, dev_d, flip, x_major)
            out[:, sel] = res.reshape(s, len(sub_idxs), ph, pw)
    return out
