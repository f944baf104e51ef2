"""6-DOF pose recovery from FDCM match candidates, multiview and plane paths
(port of :mod:`openfdcm_tpu.pose`).

The reference stops at in-plane matches and only documents the pose
procedure (``README.md:84-98``): match every view with FDCM, triangulate
and vote across views, then compose template viewpoint x in-plane rotation
x triangulated position into the 6-DOF pose, or, single-view, intersect
with a known support plane.  Per-view matching is one ``match_many`` call
for all views; the cross-view voting (every view pair x candidate x
candidate triangulated, each hypothesis reprojected into every view) is one
batched tensor program on its inputs' device.  Library linear algebra
(``torch.linalg``) is used for the 3x3 inverse and solves.

Conventions: world-to-camera extrinsics ``x_cam = R @ x_w + t``; pixels
``u = K @ x_cam`` (perspective divide); image lines are ``(N, 4)`` f32
``[x1, y1, x2, y2]`` rows like the rest of the package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import resolve_device

__all__ = [
    "Camera", "project_points", "project_lines", "backproject_rays",
    "intersect_plane", "triangulate", "match_centers",
    "multiview_vote", "MultiviewDetection", "multiview_detections",
    "six_dof_pose", "plane_pose",
]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Calibrated pinhole camera: ``k`` 3x3 intrinsics, ``r`` 3x3 / ``t``
    (3,) world-to-camera extrinsics."""
    k: np.ndarray
    r: np.ndarray
    t: np.ndarray

    @property
    def center(self) -> np.ndarray:
        """World-space camera center ``-R^T t``."""
        return -np.asarray(self.r).T @ np.asarray(self.t)


def _cam_arrays(cameras, device):
    """Stacked ``(k, r, t)`` f32 tensors ``(V, 3, 3), (V, 3, 3), (V, 3)``."""
    return tuple(torch.as_tensor(np.stack([np.asarray(getattr(c, n), np.float32)
                                           for c in cameras]), device=device)
                 for n in ("k", "r", "t"))


def _one_cam(camera: Camera, device):
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (camera.k, camera.r, camera.t))


def project_points(pts3d, k, r, t):
    """Project world points ``(..., 3)`` through ``(K, R, t)`` -> ``(...,
    2)`` pixels.  ``k``, ``r`` ``(V, 3, 3)`` and ``t`` ``(V, 3)`` project
    ``(P, 3)`` points into every view: ``(V, P, 2)``."""
    cam = pts3d @ r.mT + t.unsqueeze(-2)
    uvw = cam @ k.mT
    return uvw[..., :2] / torch.clamp_min(uvw[..., 2:3], 1e-9)


def project_lines(lines3d, camera: Camera, device="cuda") -> np.ndarray:
    """Project 3D segments ``(N, 6)`` ``[p1 p2]`` into image lines ``(N,
    4)``, on ``device``."""
    device = resolve_device(device)
    k, r, t = _one_cam(camera, device)
    l3 = torch.as_tensor(np.asarray(lines3d, np.float32), device=device)
    a = project_points(l3[:, 0:3], k, r, t)
    b = project_points(l3[:, 3:6], k, r, t)
    return torch.cat([a, b], dim=1).cpu().numpy()


def backproject_rays(pix, k, r, t):
    """Pixels ``(..., 2)`` -> world rays ``(origin (3,), dirs (..., 3))``,
    directions unit-normalized.  ``k``, ``r`` ``(V, 3, 3)``, ``t`` ``(V,
    3)`` with ``pix (V, K, 2)`` give ``origins (V, 3)``, ``dirs (V, K, 3)``."""
    ones = torch.ones(pix.shape[:-1] + (1,), dtype=pix.dtype, device=pix.device)
    d_cam = torch.cat([pix, ones], dim=-1) @ torch.linalg.inv(k).mT
    d_w = d_cam @ r                      # R^T @ d, batched
    d_w = d_w / torch.linalg.vector_norm(d_w, dim=-1, keepdim=True)
    origin = -(r.mT @ t.unsqueeze(-1))[..., 0]
    return origin, d_w


def intersect_plane(origin, dirs, plane):
    """Ray-plane intersection: ``plane`` = (nx, ny, nz, d) with ``n . x + d
    = 0``.  Returns ``(..., 3)`` world points (NaN where the ray is
    parallel)."""
    n, d = plane[:3], plane[3]
    denom = dirs @ n
    denom = torch.where(denom.abs() < 1e-9, float("nan"), denom)
    s = -(origin @ n + d) / denom
    return origin + s[..., None] * dirs


def _solve_rays(origins, dirs):
    """Least-squares points closest to the rays along the leading axis:
    ``origins`` broadcastable to ``dirs (V, ..., 3)``.  A singular system
    (parallel rays) gives non-finite or meaningless values, as the JAX
    package's solve does, and never raises."""
    eye = torch.eye(3, dtype=dirs.dtype, device=dirs.device)
    proj = eye - dirs[..., :, None] * dirs[..., None, :]   # (V, ..., 3, 3)
    a = proj.sum(dim=0)
    b = (proj @ origins.expand_as(dirs)[..., None]).sum(dim=0)
    return torch.linalg.solve_ex(a, b).result[..., 0]


def triangulate(origins, dirs):
    """Least-squares point closest to ``V`` rays (batched over leading axes
    of ``dirs``): ``origins (V, 3)``, ``dirs (V, ..., 3)`` -> ``(...,
    3)``.  Solves ``sum_v (I - d d^T) (x - o_v) = 0``."""
    o = origins.reshape((-1,) + (1,) * (dirs.ndim - 2) + (3,))
    return _solve_rays(o, dirs)


def match_centers(matches, templates) -> np.ndarray:
    """Image-space object centers of matches: each match's transform applied
    to its template's line centroid.  ``(M, 2)`` f32 (empty -> (0, 2))."""
    out = np.zeros((len(matches), 2), np.float32)
    for i, m in enumerate(matches):
        t = np.asarray(templates[m.tmpl_idx], np.float32)
        if t.shape[0] == 0:
            continue
        c = (t[:, 0:2] + t[:, 2:4]).sum(axis=0) / (2.0 * t.shape[0])
        out[i] = np.asarray(m.transform)[:2, :2] @ c + np.asarray(m.transform)[:2, 2]
    return out


def multiview_vote(centers, tmpl_idx, valid, k, r, t, *, eps_px: float = 8.0):
    """Cross-view triangulation and voting over match candidates, on the
    inputs' device.

    ``centers (V, K, 2)``: per-view candidate image centers (top-k
    matches); ``tmpl_idx (V, K)`` their template ids; ``valid (V, K)``.
    Every cross-view candidate pair is triangulated; each hypothesis is
    reprojected into every view and earns one vote per view with a
    same-template candidate within ``eps_px``.  Returns ``(points (P, 3),
    votes (P,), rms (P,), pair_idx (P, 4))`` over all hypotheses ``P =
    V*(V-1)/2 * K * K`` in the JAX package's order (view pairs row-major,
    then the two candidates), invalid ones with votes 0.

    The geometry runs in float64 and the points and rms come back as
    float32: rays from views a short baseline apart are nearly parallel,
    and in float32 their least-squares point moves by up to 0.2 units with
    the order of the roundings (the JAX package's float32 vote on
    ``tests/test_pose.py``'s 20-unit baseline at depth 500), so float32
    results would differ between devices and libraries."""
    v, kk = centers.shape[0], centers.shape[1]
    dev = centers.device
    centers, k, r, t = (x.to(torch.float64) for x in (centers, k, r, t))
    origins, dirs = backproject_rays(centers, k, r, t)       # (V, 3), (V, K, 3)

    ia, ib = torch.triu_indices(v, v, 1, device=dev)         # view pairs (Q,)
    q = ia.shape[0]
    o2 = torch.stack([origins[ia], origins[ib]])[:, :, None, None, :]
    d2 = torch.stack([dirs[ia][:, :, None, :].expand(q, kk, kk, 3),
                      dirs[ib][:, None, :, :].expand(q, kk, kk, 3)])
    pts = _solve_rays(o2, d2)                                # (Q, K, K, 3)
    same = tmpl_idx[ia][:, :, None] == tmpl_idx[ib][:, None, :]
    ok = same & valid[ia][:, :, None] & valid[ib][:, None, :]
    tid = tmpl_idx[ia][:, :, None].expand(same.shape)

    flat_pts = pts.reshape(-1, 3)                            # (P, 3)
    flat_ok = ok.reshape(-1)
    flat_tid = tid.reshape(-1)

    # reproject every hypothesis into every view
    reproj = project_points(flat_pts, k, r, t)               # (V, P, 2)
    diff = reproj[:, :, None, :] - centers[:, None, :, :]
    d2 = (diff * diff).sum(dim=-1)                           # (V, P, K)
    cand_ok = valid[:, None, :] & (tmpl_idx[:, None, :] == flat_tid[None, :, None])
    d2 = torch.where(cand_ok, d2, float("inf"))
    best = d2.amin(dim=-1)                                   # (V, P)
    hit = best < eps_px ** 2
    n_hit = hit.sum(dim=0)
    votes = torch.where(flat_ok, n_hit, 0).to(torch.int32)
    rms = torch.sqrt(torch.where(hit, best, 0.0).sum(dim=0)
                     / torch.clamp_min(n_hit, 1)).to(torch.float32)

    gq, g0, g1 = torch.meshgrid(torch.arange(q, device=dev),
                                torch.arange(kk, device=dev),
                                torch.arange(kk, device=dev), indexing="ij")
    gq, g0, g1 = gq.reshape(-1), g0.reshape(-1), g1.reshape(-1)
    pair_idx = torch.stack([ia[gq], g0, ib[gq], g1], dim=1)  # (P, 4) v0,k0,v1,k1
    return flat_pts.to(torch.float32), votes, rms, pair_idx


@dataclasses.dataclass
class MultiviewDetection:
    """A voted cross-view detection: triangulated position, supporting-view
    count, reprojection RMS, the anchor (view, candidate) pair, template."""
    point: np.ndarray       # (3,)
    votes: int
    rms: float
    tmpl_idx: int
    view_cand: tuple        # (v0, k0, v1, k1)


def multiview_detections(matches_per_view, templates, cameras, *, k: int = 10,
                         eps_px: float = 8.0, min_votes: int = 2,
                         device="cuda") -> list:
    """Full multiview stage: per-view top-k match candidates -> voting on
    ``device`` -> ranked :class:`MultiviewDetection` list (votes desc, rms
    asc, ranked on the host).

    ``matches_per_view``: ``list[list[Match]]`` (e.g. from ``match_many``
    on the per-view scenes, one call for all views)."""
    device = resolve_device(device)
    v = len(matches_per_view)
    host_templates = [np.asarray(t, np.float32) for t in templates]
    centers = np.zeros((v, k, 2), np.float32)
    tidx = np.full((v, k), -1, np.int32)
    valid = np.zeros((v, k), bool)
    for vi, ms in enumerate(matches_per_view):
        ms = ms[:k]
        centers[vi, : len(ms)] = match_centers(ms, host_templates)
        tidx[vi, : len(ms)] = [m.tmpl_idx for m in ms]
        valid[vi, : len(ms)] = True
    as_dev = lambda a: torch.as_tensor(a, device=device)
    pts, votes, rms, pair_idx = (x.cpu().numpy() for x in multiview_vote(
        as_dev(centers), as_dev(tidx), as_dev(valid),
        *_cam_arrays(cameras, device), eps_px=float(eps_px)))
    order = np.lexsort((rms, -votes))
    out = []
    seen = set()
    for i in order:
        if votes[i] < min_votes:
            break
        v0, k0, v1, k1 = (int(x) for x in pair_idx[i])
        anchor = (v0, k0)
        if anchor in seen:       # keep the best hypothesis per anchor cand
            continue
        seen.add(anchor)
        out.append(MultiviewDetection(
            point=pts[i].copy(), votes=int(votes[i]), rms=float(rms[i]),
            tmpl_idx=int(tidx[v0, k0]), view_cand=(v0, k0, v1, k1)))
    return out


def _in_plane_angle(transform) -> float:
    m = np.asarray(transform)
    return float(np.arctan2(m[1, 0], m[0, 0]))


def _rz(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)


def six_dof_pose(detection: MultiviewDetection, matches_per_view,
                 template_rotations, cameras) -> np.ndarray:
    """Compose the full 6-DOF pose ``(4, 4)`` world-from-object (host):
    ``R = R_wc @ Rz(theta_inplane) @ R_view(tmpl)``, ``t`` = triangulated
    point (README.md:98 step 5).  ``template_rotations``: per-template 3x3
    viewpoint rotation from the sampling stage (object-from-canonical)."""
    v0, k0 = detection.view_cand[:2]
    m = matches_per_view[v0][k0]
    r_view = np.asarray(template_rotations[m.tmpl_idx], np.float64)
    r_wc = np.asarray(cameras[v0].r, np.float64).T
    pose = np.eye(4)
    pose[:3, :3] = r_wc @ _rz(_in_plane_angle(m.transform)) @ r_view
    pose[:3, 3] = detection.point
    return pose


def plane_pose(match, templates, template_rotations, camera: Camera,
               plane, device="cuda") -> np.ndarray:
    """Single-view 6-DOF under the known-support-plane hypothesis
    (README.md:91): back-project the match center onto ``plane`` on
    ``device`` for T(3), compose R like :func:`six_dof_pose`."""
    device = resolve_device(device)
    c = match_centers([match], [np.asarray(t, np.float32) for t in templates])
    k, r, t = _one_cam(camera, device)
    origin, dirs = backproject_rays(torch.as_tensor(c, device=device), k, r, t)
    pt = intersect_plane(origin, dirs, torch.as_tensor(
        np.asarray(plane, np.float32), device=device)).cpu().numpy()[0]
    pose = np.eye(4)
    pose[:3, :3] = np.asarray(camera.r, np.float64).T \
        @ _rz(_in_plane_angle(match.transform)) \
        @ np.asarray(template_rotations[match.tmpl_idx], np.float64)
    pose[:3, 3] = pt
    return pose
