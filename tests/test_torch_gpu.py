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
