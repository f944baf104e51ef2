"""Each CUDA kernel against its plain PyTorch version on the card, at small
random shapes, and the slice on CUDA against the slice on the CPU.

Needs an NVIDIA GPU (marker ``gpu``); skipped elsewhere.  On a GPU host
without JAX, run with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py tests/test_torch_imports.py``.
"""
import numpy as np
import pytest
import torch

import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.core.dt import _nearest_1d_l1
from openfdcm_tpu_torch.core.types import F32_MAX
from openfdcm_tpu_torch.matching import featuremap as tfm
from openfdcm_tpu_torch.ops import integral, minplus, prop, window
from openfdcm_tpu_torch.ops import window_v2, window_v3

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(got[ok], want[ok])


def test_minplus_kernel_bit_equal():
    rng = np.random.default_rng(0)
    g = np.where(rng.uniform(size=(96, 300)) < 0.03,
                 rng.integers(0, 40, (96, 300)), F32_MAX).astype(np.float32)
    g[5] = F32_MAX
    gt = torch.as_tensor(g)
    g2, l1 = gt * gt, _nearest_1d_l1(gt)
    _same(minplus.minplus_rows(g2.cuda(), l1.cuda()),
          minplus.minplus_rows_plain(g2, l1))


def test_prop_kernel_bit_equal():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(0, 100, (2, 12, 24, 40)).astype(np.float32))
    steps = tfm.propagation_steps(tfm.make_angles(12), 5.0)
    _same(prop.propagate_orientation(x.cuda(), steps),
          prop.propagate_orientation_plain(x, steps))


@pytest.mark.parametrize("x_major", [True, False])
@pytest.mark.parametrize("flip", [False, True])
def test_sweep_kernel_bit_equal(x_major, flip):
    rng = np.random.default_rng(2)
    imgs = torch.as_tensor(rng.uniform(0, 10, (5, 48, 72)).astype(np.float32))
    n = 72 if x_major else 48
    d = torch.as_tensor(rng.integers(-1, 2, (5, n)).astype(np.int32))
    _same(integral.sweep_scan(imgs.cuda(), d.cuda(), flip, x_major),
          integral.sweep_scan_plain(imgs, d, flip, x_major))


@pytest.mark.parametrize("count,two_sided", [(128, True), (64, False), (10, False)])
def test_window_kernel_bit_equal(count, two_sided):
    rng = np.random.default_rng(3)
    m, l = 70, 6
    args = (rng.uniform(0, 100, (2, 4, 96, 96)).astype(np.float32),
            rng.uniform(-20, 120, (m, l, 4)).astype(np.float32),
            rng.integers(0, 8, (m, l)).astype(np.int32),
            (rng.uniform(size=(m, l)) < 0.8).astype(np.float32),
            rng.uniform(-5, 5, (m, 2)).astype(np.float32),
            rng.uniform(-1, 1, (m, 2)).astype(np.float32),
            rng.integers(0, 40, m).astype(np.float32))
    cpu = tuple(torch.as_tensor(a) for a in args)
    _same(window.window_scores(*(a.cuda() for a in cpu), count=count,
                               two_sided=two_sided),
          window.window_scores_plain(*cpu, count=count, two_sided=two_sided))


@pytest.mark.parametrize("major", ["x", "y"])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("version", [2, 3])
def test_window_v2_v3_kernel_bit_equal(version, two_sided, major):
    """K5/K6 on the inputs their entries build (CPU), against the plain
    version: every lane, lines near and beyond the canvas edges."""
    rng = np.random.default_rng(5)
    s, c, l, d, q = 2, 37, 6, 4, 256
    li = torch.as_tensor(rng.uniform(0, 100, (s, d, q, q)).astype(np.float32))
    center = rng.uniform(-10, q + 10, (s * c, l, 2))
    delta = rng.uniform(-9, 9, (s * c, l, 2))
    lines = torch.as_tensor(np.concatenate([center - delta, center + delta],
                                           -1).astype(np.float32))
    ang = rng.uniform(-0.7, 0.7, s * c) + (0.0 if major == "x" else np.pi / 2)
    v = torch.as_tensor(np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32))
    v = v / v.abs().amax(dim=-1, keepdim=True)
    scene_of = torch.as_tensor(np.repeat(np.arange(s), c))
    slice_idx = torch.as_tensor(rng.integers(0, d, (s * c, l)))
    mask = torch.as_tensor(rng.uniform(size=(s * c, l)) < 0.85)
    gate = torch.as_tensor(rng.uniform(size=s * c) < 0.9)
    tr = torch.as_tensor(rng.uniform(5, 25, (s * c, 2)).astype(np.float32))
    t0 = (torch.zeros(s * c) if two_sided
          else torch.as_tensor(rng.integers(1, 50, s * c).astype(np.float32)))
    sid = (slice_idx + scene_of[:, None] * d).to(torch.int32)
    if version == 2:
        args, tc = window_v2._fields(li, lines, mask, v, gate, tr, t0, sid,
                                     slice_idx, budget=10.0 if two_sided else 20.0,
                                     two_sided=two_sided)
        kernel, plain = window_v2.window_v2, window_v2.window_v2_plain
    else:
        args, tc = window_v3._fields(li, lines, mask, v, gate, tr, t0, sid,
                                     slice_idx, two_sided=two_sided)
        kernel, plain = window_v3.window_v3, window_v3.window_v3_plain
    assert (args[-1] == (1 if major == "x" else 0)).all()
    before = kernel.launches
    _same(kernel(li.cuda(), *(a.cuda() for a in args), two_sided=two_sided),
          plain(li, *args, two_sided=two_sided))
    assert kernel.launches == before + 1


def test_slice_cuda_matches_cpu():
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 60, (7, 4)).astype(np.float32)
    templates = [base, base[:5] * np.float32(0.8)]
    scenes = [np.concatenate([base + 20, rng.uniform(0, 100, (8, 4))]).astype(np.float32),
              np.concatenate([base[:5] * 0.8 + 30, rng.uniform(0, 100, (8, 4))]).astype(np.float32)]
    args = (scenes, templates, ot.Dt3Params(8, 5.0, 1.5, ot.Distance.L2),
            ot.DefaultSearch(3, 5), ot.BatchOptimize(5))
    kw = dict(penalty=ot.ExponentialPenalty(1.5), top_k=6)
    got = ot.match_many(*args, device="cuda", **kw)
    want = ot.match_many(*args, device="cpu", **kw)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            assert g.tmpl_idx == w.tmpl_idx
            assert np.isclose(g.score, w.score, rtol=1e-6, atol=0)   # powf ulp
            np.testing.assert_allclose(g.transform, w.transform, rtol=1e-6,
                                       atol=1e-5)


@pytest.mark.parametrize("tc", [63, 7])
def test_forced_stragglers_cuda_matches_cpu(monkeypatch, tc):
    """Walks far beyond the covered window run the extension pass and the
    lockstep walk backstop on K1; CUDA and CPU agree exactly."""
    from openfdcm_tpu_torch.matching import optimize as topt
    from openfdcm_tpu_torch.matching import optimize_kernel as tok
    monkeypatch.setattr(tok, "TC", tc)
    depth, q = 8, 256
    rng = np.random.default_rng(11)
    base = (np.arange(q, dtype=np.float32)[::-1] * 3.0)[None, None, :]
    dt3 = np.broadcast_to(base, (depth, q, q)).copy()
    dt3 += rng.uniform(0, 0.5, (depth, q, q)).astype(np.float32)
    dt3 = np.cumsum(dt3, axis=2, dtype=np.float32)[None]
    c, l = 24, 4
    p1 = rng.uniform(40, 120, (c, l, 2)).astype(np.float32)
    d = rng.uniform(-12, 12, (c, l, 2)).astype(np.float32)
    cand = np.concatenate([p1, p1 + d], axis=-1)[None]
    ang = rng.uniform(-0.8, 0.8, c).astype(np.float32)
    align = np.stack([np.cos(ang), np.sin(ang)], axis=-1)[None]
    inputs = (dt3, tfm.make_angles(depth), np.zeros((1, 2), np.float32),
              np.asarray([[q, q]], np.float32), cand, np.ones((1, c, l), bool),
              align)
    out = {}
    for dev in ("cuda", "cpu"):
        before = topt.host_sync.count
        out[dev] = tok.optimize_candidates_batch_kernel(
            *(torch.as_tensor(a, device=dev) for a in inputs), mode="batch",
            window=10)
        out[dev + "_syncs"] = topt.host_sync.count - before
    for g, w in zip(out["cuda"], out["cpu"]):
        _same(g, w)
    assert out["cuda_syncs"] == out["cpu_syncs"] > 4     # the walk ran
    assert out["cpu"][1].abs().max() > 100


@pytest.mark.parametrize("mode", ["default", "indulgent", "batch"])
@pytest.mark.parametrize("version", [2, 3])
def test_generations_cuda_match_cpu(monkeypatch, version, mode):
    """The optimizer under window generation 2 or 3, with forced
    stragglers, and ``match_many`` with the greedy walks: CUDA and CPU
    agree exactly (the slice's penalty ``powf`` to an ulp)."""
    from openfdcm_tpu_torch.matching import optimize_kernel as tok
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    depth, q = 6, 256
    rng = np.random.default_rng(12)
    base = (np.arange(q, dtype=np.float32)[::-1] * 3.0)[None, None, :]
    dt3 = np.broadcast_to(base, (depth, q, q)).copy()
    dt3 += rng.uniform(0, 0.5, (depth, q, q)).astype(np.float32)
    dt3 = np.cumsum(dt3, axis=2, dtype=np.float32)[None]
    c, l = 30, 4
    p1 = rng.uniform(40, 120, (c, l, 2)).astype(np.float32)
    d = rng.uniform(-12, 12, (c, l, 2)).astype(np.float32)
    cand = np.concatenate([p1, p1 + d], axis=-1)[None]
    ang = rng.uniform(-0.8, 0.8, c).astype(np.float32)
    align = np.stack([np.cos(ang), np.sin(ang)], axis=-1)[None]
    inputs = (dt3, tfm.make_angles(depth), np.zeros((1, 2), np.float32),
              np.asarray([[q, q]], np.float32), cand, np.ones((1, c, l), bool),
              align)
    window = 10 if mode == "batch" else 32
    out = {dev: tok.optimize_candidates_batch_kernel(
        *(torch.as_tensor(a, device=dev) for a in inputs), mode=mode,
        window=window) for dev in ("cuda", "cpu")}
    for g, w in zip(out["cuda"], out["cpu"]):
        _same(g, w)
    assert out["cpu"][1].abs().max() > 100

    base_lines = rng.uniform(0, 120, (9, 4)).astype(np.float32)
    templates = [base_lines, base_lines[:6] * np.float32(0.8)]
    scenes = [np.concatenate([base_lines + 40, rng.uniform(0, 200, (10, 4))]).astype(np.float32)]
    optimizer = {"default": ot.DefaultOptimize(), "indulgent": ot.IndulgentOptimize(),
                 "batch": ot.BatchOptimize(5)}[mode]
    kw = dict(penalty=ot.ExponentialPenalty(1.5), top_k=6)
    args = (scenes, templates, ot.Dt3Params(8, 5.0, 1.5, ot.Distance.L2),
            ot.DefaultSearch(3, 5), optimizer)
    got = ot.match_many(*args, device="cuda", **kw)
    want = ot.match_many(*args, device="cpu", **kw)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            assert g.tmpl_idx == w.tmpl_idx
            assert np.isclose(g.score, w.score, rtol=1e-6, atol=0)
            np.testing.assert_allclose(g.transform, w.transform, rtol=1e-6,
                                       atol=1e-5)
