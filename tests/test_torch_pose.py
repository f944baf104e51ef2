"""The port's pose stage on the CPU against :mod:`openfdcm_tpu.pose`:
primitives (atol 1e-4), ``multiview_vote`` (votes and ``pair_idx`` equal,
points atol 1e-3) and the end-to-end recovery of ``tests/test_pose.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import openfdcm_tpu_torch as ot
from openfdcm_tpu import pose as jpose
from openfdcm_tpu_torch import pose
from tests.test_pose import _render_views, _lift
from tests.utils import create_lines, make_rotation

torch.set_num_threads(1)

DEV = dict(device="cpu")


def _cam(cx, f=500.0, z=500.0, yaw=0.0):
    k = np.asarray([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1]], np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    r = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = np.asarray([-cx, 0.0, z], np.float32)
    return pose.Camera(k, r, t)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_primitives_match_jax():
    rng = np.random.default_rng(0)
    cam = _cam(30.0, yaw=0.1)
    k, r, t = (np.asarray(a) for a in (cam.k, cam.r, cam.t))
    pts = rng.uniform(-80, 80, (50, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    got = pose.project_points(_t(pts), _t(k), _t(r), _t(t))
    want = jpose.project_points(jnp.asarray(pts), k, r, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    o, d = pose.backproject_rays(got, _t(k), _t(r), _t(t))
    jo, jd = jpose.backproject_rays(want, k, r, t)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-4)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4)

    plane = np.asarray([0.05, -0.02, 1.0, 3.0], np.float32)
    hit = pose.intersect_plane(o, d, _t(plane))
    np.testing.assert_allclose(hit.numpy(),
                               np.asarray(jpose.intersect_plane(jo, jd, plane)),
                               rtol=1e-4, atol=1e-3)
    # a ray parallel to the plane gives NaN
    par = pose.intersect_plane(_t([0, 0, 0]), _t([[1, 0, 0]]), _t([0, 0, 1, 0]))
    assert par.isnan().all()

    lines3d = rng.uniform(-60, 60, (12, 6)).astype(np.float32)
    lines3d[:, [2, 5]] = 0.0
    np.testing.assert_allclose(pose.project_lines(lines3d, cam, **DEV),
                               jpose.project_lines(lines3d, cam), atol=1e-4)


def test_triangulate_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(-10, 10, (7, 3)).astype(np.float32)
    o = np.asarray([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0], [0.0, 8.0, -2.0]], np.float32)
    d = p[None] - o[:, None]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    got = pose.triangulate(_t(o), _t(d)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpose.triangulate(o, d)), atol=1e-4)
    np.testing.assert_allclose(got, p, atol=1e-3)


def _vote_inputs(seed, v=4, k=6, f=100.0, baseline=60.0):
    """Candidates of ``v`` views ``baseline`` apart at depth and focal
    length ``f``: a few true objects seen by most views, spurious
    candidates, invalid padding."""
    rng = np.random.default_rng(seed)
    cams = [_cam(baseline * i, f=f, z=f) for i in range(v)]
    kk, rr, tt = (np.stack([np.asarray(getattr(c, n)) for c in cams])
                  for n in ("k", "r", "t"))
    objs = rng.uniform(-60, 60, (3, 3)).astype(np.float32)
    objs[:, 2] = rng.uniform(-5, 5, 3)
    centers = rng.uniform(0, 640, (v, k, 2)).astype(np.float32)
    tidx = rng.integers(0, 5, (v, k)).astype(np.int32)
    valid = rng.uniform(size=(v, k)) < 0.85
    for vi in range(v):
        pix = np.asarray(jpose.project_points(objs, kk[vi], rr[vi], tt[vi]))
        for oi in range(3):
            if rng.uniform() < 0.8:
                j = int(rng.integers(k))
                centers[vi, j] = pix[oi] + rng.normal(0, 0.7, 2)
                tidx[vi, j], valid[vi, j] = oi, True
    return cams, centers, tidx, valid, (kk, rr, tt)


def _ray(c, k, r):
    d = r.T.astype(np.float64) @ (np.linalg.inv(k.astype(np.float64)) @ np.append(c, 1.0))
    return d / np.linalg.norm(d)


def _vote_f64(centers, pair_idx, kk, rr, tt):
    """Each hypothesis's least-squares point of its two rays in numpy f64,
    and the angle between the rays."""
    pts, angles = [], []
    for v0, k0, v1, k1 in pair_idx:
        a, b, rays = np.zeros((3, 3)), np.zeros(3), []
        for vi, ki in ((v0, k0), (v1, k1)):
            d = _ray(centers[vi, ki], kk[vi], rr[vi])
            proj = np.eye(3) - np.outer(d, d)
            a += proj
            b += proj @ (-rr[vi].T.astype(np.float64) @ tt[vi].astype(np.float64))
            rays.append(d)
        pts.append(np.linalg.solve(a, b))
        angles.append(np.arccos(np.clip(rays[0] @ rays[1], -1.0, 1.0)))
    return np.asarray(pts), np.asarray(angles)


# rays that meet at 0.3 rad or more: there the JAX package's float32 solve
# is within 6e-4 of the float64 point on these views (up to 2.5e-3 below)
WIDE = 0.3


def _check_points(got, want, pair_idx, centers, cams):
    """The port's points equal the float64 solve (to float32 rounding);
    where the rays meet at ``WIDE`` or more, the JAX package's within atol
    1e-3.  Returns how many were held against the JAX package."""
    kk, rr, tt = (np.stack([np.asarray(getattr(c, n)) for c in cams])
                  for n in ("k", "r", "t"))
    exact, angles = _vote_f64(centers, pair_idx, kk, rr, tt)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-4)
    wide = angles >= WIDE
    np.testing.assert_allclose(got[wide], want[wide], atol=1e-3)
    return int(wide.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multiview_vote_matches_jax(seed):
    """Votes and ``pair_idx`` equal; the voted hypotheses' points exact to
    float32 rounding, and within atol 1e-3 of the JAX package's where that
    package's float32 solve is well conditioned (rays at ``WIDE`` or more;
    the hypotheses of padding candidates have parallel rays, non-finite or
    arbitrary points in both packages, and no votes)."""
    cams, centers, tidx, valid, (kk, rr, tt) = _vote_inputs(seed)
    got = [x.numpy() for x in pose.multiview_vote(
        _t(centers), torch.as_tensor(tidx), torch.as_tensor(valid), _t(kk),
        _t(rr), _t(tt), eps_px=6.0)]
    want = [np.asarray(x) for x in jpose.multiview_vote(
        jnp.asarray(centers), jnp.asarray(tidx), jnp.asarray(valid), kk, rr, tt,
        eps_px=6.0)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[1].dtype == want[1].dtype == np.int32
    voted = want[1] > 0
    assert voted.sum() > 5 and want[1].max() >= 3
    assert _check_points(got[0][voted], want[0][voted], got[3][voted], centers,
                         cams) >= 3
    np.testing.assert_allclose(got[2][voted], want[2][voted], atol=1e-3)


def test_multiview_vote_short_baseline_is_exact():
    """Views 20 units apart at depth 500 (``tests/test_pose.py``'s cameras):
    the port's float64 vote equals a numpy float64 solve to float32
    rounding, where the JAX package's float32 vote is up to 0.2 off."""
    cams, centers, tidx, valid, (kk, rr, tt) = _vote_inputs(5, f=500.0, baseline=20.0)
    pts, votes, _, pidx = (x.numpy() for x in pose.multiview_vote(
        _t(centers), torch.as_tensor(tidx), torch.as_tensor(valid), _t(kk),
        _t(rr), _t(tt), eps_px=6.0))
    voted = votes > 0
    assert voted.sum() > 5
    want, _ = _vote_f64(centers, pidx[voted], kk, rr, tt)
    np.testing.assert_allclose(pts[voted], want, rtol=1e-6, atol=1e-4)


def test_multiview_detections_match_jax():
    cams, centers, tidx, valid, _ = _vote_inputs(3)
    templates = [np.asarray(create_lines(5, 20.0))] * 5
    c = (templates[0][:, :2] + templates[0][:, 2:]).sum(0) / 10.0
    matches = []
    for vi in range(len(cams)):
        matches.append([ot.Match(int(tidx[vi, j]), 0.0, np.concatenate(
            [np.eye(2), (centers[vi, j] - c)[:, None]], 1).astype(np.float32))
            for j in np.nonzero(valid[vi])[0]])
    got = pose.multiview_detections(matches, templates, cams, k=6, eps_px=6.0, **DEV)
    want = jpose.multiview_detections(matches, templates, cams, k=6, eps_px=6.0)
    assert len(got) == len(want) > 0
    assert [(g.votes, g.tmpl_idx, g.view_cand) for g in got] == \
        [(w.votes, w.tmpl_idx, w.view_cand) for w in want]
    # the detections' centers, as multiview_detections computes them
    cent = np.zeros((len(cams), 6, 2), np.float32)
    for vi, ms in enumerate(matches):
        cent[vi, : len(ms)] = pose.match_centers(ms[:6], templates)
    _check_points(np.stack([g.point for g in got]), np.stack([w.point for w in want]),
                  [g.view_cand for g in got], cent, cams)


def test_multiview_end_to_end():
    """``tests/test_pose.py::test_multiview_end_to_end`` on the port, depth 8."""
    theta, p_gt = 0.4, (60.0, 50.0)
    tmpl, cams, _ = _render_views(theta, p_gt)
    rot = make_rotation(theta)
    world2d = np.concatenate([tmpl[:, :2] @ rot.T, tmpl[:, 2:] @ rot.T], axis=1) \
        + np.asarray([p_gt[0], p_gt[1], p_gt[0], p_gt[1]], np.float32)
    scenes = [pose.project_lines(_lift(world2d), c, **DEV) for c in cams]
    params = ot.Dt3Params(8, 5.0, 2.2, ot.Distance.L2)
    matches = ot.match_many(scenes, [tmpl], params, ot.DefaultSearch(4, 10),
                            ot.BatchOptimize(10), top_k=6, **DEV)
    assert all(len(m) > 0 for m in matches)
    dets = pose.multiview_detections(matches, [tmpl], cams, k=6, eps_px=6.0, **DEV)
    assert dets, "no cross-view consensus found"
    best = dets[0]
    assert best.votes == 2
    centroid = (tmpl[:, 0:2] + tmpl[:, 2:4]).sum(axis=0) / (2.0 * tmpl.shape[0])
    expect = rot @ centroid + np.asarray(p_gt, np.float32)
    np.testing.assert_allclose(best.point[:2], expect, atol=2.5)
    assert abs(best.point[2]) < 2.5

    p = pose.six_dof_pose(best, matches, [np.eye(3)], cams)
    ang = np.arctan2(p[1, 0], p[0, 0])
    assert min(abs(ang - theta), abs(abs(ang - theta) - np.pi)) < 0.15
    np.testing.assert_allclose(p[:3, 3][:2], expect, atol=2.5)

    pp = pose.plane_pose(matches[0][0], [tmpl], [np.eye(3)], cams[0],
                         np.asarray([0, 0, 1, 0], np.float32), **DEV)
    np.testing.assert_allclose(pp[:3, 3][:2], expect, atol=2.5)
    assert abs(pp[2, 3]) < 1e-3


def test_pose_entries_need_cuda_unless_given_cpu(monkeypatch):
    cams, centers, tidx, valid, _ = _vote_inputs(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pose.multiview_detections([[]] * len(cams), [], cams)
    with pytest.raises(RuntimeError, match="CUDA"):
        pose.project_lines(np.zeros((1, 6)), cams[0])
