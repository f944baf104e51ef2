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
from torch_steps import revisit_steps, self_steps  # tests/torch_steps.py

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


def _column_pass(seed, shape, density):
    """Column-pass distances of a sparse random seed image, on the card."""
    rng = np.random.default_rng(seed)
    ind = np.where(rng.uniform(size=shape) < density, 0.0, F32_MAX).astype(np.float32)
    return _nearest_1d_l1(torch.as_tensor(ind, device="cuda"), dim=-2)


@pytest.mark.parametrize("sqrt", [False, True])
def test_minplus_kernel_bit_equal(sqrt):
    """K2 on sparse 640 px slices (a seedless one among them) and on 8191 px
    rows (pixels beyond 2^24 and the tie of
    ``test_k2_mirror_beyond_the_exact_range``), against the plain version
    (exact, so run on the card too)."""
    g = _column_pass(0, (2, 6, 640, 640), 2e-4)
    g[1, 2] = F32_MAX
    wide = _column_pass(1, (1, 8, 8191), 4e-4)
    wide[0, 0] = F32_MAX
    wide[0, 0, 0], wide[0, 0, 8190] = 181, 1
    before = minplus.minplus_rows.launches
    for x in (g, wide):
        _same(minplus.minplus_rows(x, sqrt=sqrt),
              minplus.minplus_rows_plain(x, sqrt=sqrt))
    assert minplus.minplus_rows.launches == before + 2


def test_prop_kernel_bit_equal():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(0, 100, (2, 12, 24, 40)).astype(np.float32))
    steps = tfm.propagation_steps(tfm.make_angles(12), 5.0)
    _same(prop.propagate_orientation(x.cuda(), steps),
          prop.propagate_orientation_plain(x, steps))


@pytest.mark.parametrize("depth,h,w", [(30, 640, 640), (60, 640, 640),
                                       (30, 33, 71), (12, 31, 33)])
def test_prop_kernel_in_place(depth, h, w):
    """K3 at the repo's depths on a 640 px canvas (the unrolled kernel, two
    pixels a thread below depth 60) and on odd canvases (one pixel a
    thread), in place: the returned tensor is the input, and NaN
    propagates."""
    rng = np.random.default_rng(depth)
    x = torch.as_tensor(rng.uniform(0, 100, (2, depth, h, w)).astype(np.float32))
    x[0, 3, 5, 7] = float("nan")
    steps = tfm.propagation_steps(tfm.make_angles(depth), 5.0)
    want = prop.propagate_orientation_plain(x, steps)
    dev = x.cuda()
    before = prop.propagate_orientation.launches
    assert prop.propagate_orientation(dev, steps) is dev
    assert prop.propagate_orientation.launches == before + 1
    _same(dev, want)


@pytest.mark.parametrize("depth,reverse", [(7, False), (30, True)])
def test_prop_general_kernel_in_place(depth, reverse):
    """The general kernel: a depth with no unrolled instantiation, and the
    depth-30 steps in another order."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.uniform(0, 100, (3, depth, 33, 70)).astype(np.float32))
    steps = tfm.propagation_steps(tfm.make_angles(depth), 3.0)
    steps = steps[::-1] if reverse else steps
    dev = x.cuda()
    assert prop.propagate_orientation(dev, steps) is dev
    _same(dev, prop.propagate_orientation_plain(x, steps))


@pytest.mark.parametrize("x_major", [True, False])
@pytest.mark.parametrize("flip", [False, True])
def test_sweep_kernel_bit_equal(x_major, flip):
    """K4 in place on 640 px slices with random deltas (paths that leave
    and re-enter the canvas), against the plain version on the card."""
    rng = np.random.default_rng(2)
    imgs = torch.as_tensor(rng.uniform(0, 10, (2, 3, 640, 640)).astype(np.float32),
                           device="cuda")
    deltas = rng.integers(-1, 2, (6, 640)).astype(np.int32)
    table = np.array([(x_major, flip, i) for i in range(6)], np.int32)
    want = integral.sweep_stack_plain(imgs.clone(), deltas, table)
    got = imgs.clone()
    before = integral.sweep_stack.launches
    assert integral.sweep_stack(got, deltas, table) is got
    assert integral.sweep_stack.launches == before + 1
    _same(got, want)


def test_line_integral_stack_cuda_matches_cpu():
    """The DT3 angle bank plus two x-major flipped angles on a padded
    640 px canvas (per-scene delta rows), one K4 launch, against the CPU."""
    from openfdcm_tpu_torch.core import integral as core_integral
    rng = np.random.default_rng(6)
    angles = np.concatenate([tfm.make_angles(30), [2.8, -2.9]]).astype(np.float32)
    lhw = np.array([[620, 600], [640, 517], [577, 640]], np.int64)
    imgs = rng.uniform(0, 9, (3, 32, 640, 640)).astype(np.float32)
    for i, (h, w) in enumerate(lhw):
        imgs[i, :, h:, :] = 0.0
        imgs[i, :, :, w:] = 0.0
    want = core_integral.line_integral_stack_batch_(torch.tensor(imgs), angles, lhw)
    before = integral.sweep_stack.launches
    got = core_integral.line_integral_stack_batch_(
        torch.tensor(imgs, device="cuda"), angles, lhw)
    assert integral.sweep_stack.launches == before + 1
    _same(got, want)


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


def _rasterized_case(seed, shape, m, n_lines):
    """K1 inputs on a multi-slice stack: rasterized step vectors of both
    majors and signs (the first ten fixed); endpoints inside the canvas, 70
    px or a third of it from the edges, except every third candidate's,
    which lie anywhere up to 40 px beyond each edge; slice ids at both ends
    of the stack and outside it; weight-0 lines and a weight-0 candidate."""
    rng = np.random.default_rng(seed)
    s, d, h, w = shape
    ang = rng.uniform(0, 2 * np.pi, m)
    v = np.stack([np.cos(ang), np.sin(ang)], -1)
    v = v / np.abs(v).max(-1, keepdims=True)
    v[:10] = [[1, 0.3], [-1, -0.7], [0.2, 1], [-0.9, -1], [1, 0], [0, 1],
              [-1, 0], [0, -1], [1, 1], [-1, 1]]
    wide = (np.arange(m) % 3 == 0)[:, None]

    def coord(size):
        inner = min(70.0, size / 3)
        return np.where(wide, rng.uniform(-40, size + 40, (m, n_lines)),
                        rng.uniform(inner, size - inner, (m, n_lines)))
    ep = np.stack([coord(w), coord(h), coord(w), coord(h)], -1)
    sid = rng.integers(0, s * d, (m, n_lines))
    sid[::3, 0], sid[1::3, -1] = 0, s * d - 1
    sid[::7, -1], sid[::11, 0] = -1, s * d
    wt = np.where(rng.uniform(size=(m, n_lines)) < 0.75,
                  rng.uniform(0.5, 2.0, (m, n_lines)), 0.0)
    wt[5] = 0.0
    return tuple(torch.as_tensor(a) for a in (
        rng.uniform(0, 100, shape).astype(np.float32), ep.astype(np.float32),
        sid.astype(np.int32), wt.astype(np.float32),
        rng.uniform(-3, 3, (m, 2)).astype(np.float32), v.astype(np.float32),
        rng.integers(0, 50, m).astype(np.float32)))


@pytest.mark.parametrize("count,two_sided", [(128, True), (64, False), (10, False),
                                             (1, False)])
def test_window_kernel_rasterized_640(count, two_sided):
    """K1 on both layouts (the tiled copy and the row-major stack) against
    the plain version: rasterized x- and y-major walks over a 640 px
    three-slice stack, probes that leave the slice at each edge and the
    stack at both ends, every lane pattern, weight-0 lines."""
    cpu = _rasterized_case(7, (1, 3, 640, 640), 300, 12)
    if two_sided:
        cpu = cpu[:-1] + (torch.zeros_like(cpu[-1]),)
    want = window.window_scores_plain(*cpu, count=count, two_sided=two_sided)
    dev = tuple(a.cuda() for a in cpu)
    tiles = window.tile_stack(dev[0])
    for kw in (dict(tiles=tiles), {}):
        before = window.window_scores.launches
        _same(window.window_scores(*dev, count=count, two_sided=two_sided, **kw),
              want)
        assert window.window_scores.launches == before + 1


@pytest.mark.parametrize("shape", [(1, 3, 640, 640), (2, 3, 42, 57)])
def test_tile_stack_kernel_bit_equal(shape):
    """K1's tile copy against its plain version, on whole tiles and on a
    canvas that pads its last tile row and column (and a tiled read of the
    padded canvas against the plain window scores)."""
    cpu = _rasterized_case(8, shape, 120, 9)
    before = window.tile_stack.launches
    tiles = window.tile_stack(cpu[0].cuda())
    assert window.tile_stack.launches == before + 1
    _same(tiles, window.tile_stack_plain(cpu[0]))
    _same(window.window_scores(*(a.cuda() for a in cpu), count=64,
                               two_sided=False, tiles=tiles),
          window.window_scores_plain(*cpu, count=64, two_sided=False))


def v2v3_case(version, two_sided, major, *, seed=5, s=2, c=37, l=6, d=4,
              q=256, edges=False):
    """K5 (``version`` 2) or K6 (3) inputs as their entries build them, on
    the CPU: ``(li, args)`` with ``args`` the wrapper's positional inputs
    after ``li``.  Lines near and beyond the canvas edges, one major.
    ``edges``: also a candidate with every weight 0 (as a quarantined one),
    a NaN weight, slice ids below and beyond the stack and, for K5, patch
    origins beyond the canvas."""
    rng = np.random.default_rng(seed)
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
        args, _ = window_v2._fields(li, lines, mask, v, gate, tr, t0, sid,
                                    slice_idx, budget=10.0 if two_sided else 20.0,
                                    two_sided=two_sided)
    else:
        args, _ = window_v3._fields(li, lines, mask, v, gate, tr, t0, sid,
                                    slice_idx, two_sided=two_sided)
    assert (args[-1] == (1 if major == "x" else 0)).all()
    if edges:
        args = list(args)
        w_i = 3 if version == 2 else 2
        wt, sid = args[w_i].clone(), args[w_i - 1].clone()
        gate_ok = gate.nonzero()[:, 0]
        wt[gate_ok[0]] = 0.0
        wt[gate_ok[1], 0] = float("nan")
        sid[gate_ok[2], 0], sid[gate_ok[3], -1] = -1, s * d
        sid[gate_ok[4], 1] = s * d + 5
        args[w_i], args[w_i - 1] = wt, sid
        if version == 2:
            org = args[1].clone()
            org[gate_ok[5], 0, 0], org[gate_ok[6], 1, 3] = -7, q - 20
            org[gate_ok[7], 2, 2] = q
            args[1] = org
        args = tuple(args)
    return li, args


@pytest.mark.parametrize("layout", ["tiles", "rows"])
@pytest.mark.parametrize("major", ["x", "y"])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("version", [2, 3])
def test_window_v2_v3_kernel_bit_equal(version, two_sided, major, layout):
    """K5/K6 on the inputs their entries build (CPU), against the plain
    version: every lane, lines near and beyond the canvas edges, on the
    tiled copy and on the row-major stack."""
    li, args = v2v3_case(version, two_sided, major)
    _v2v3_same(version, two_sided, layout, li, args)


@pytest.mark.parametrize("layout", ["tiles", "rows"])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("version,q", [(2, 260), (2, 384), (3, 384)])
def test_window_v2_v3_kernel_edges(version, q, two_sided, layout):
    """K5/K6 on 384 px and (K5) 260 px canvases (a tiled copy with a padded
    tile column), 40 lines per candidate (two staging rounds), with a
    weight-0 candidate, a NaN weight, slice ids outside the stack and (K5)
    patch origins beyond the canvas, both majors."""
    for major in ("x", "y"):
        li, args = v2v3_case(version, two_sided, major, seed=8, c=20, l=40,
                             q=q, edges=True)
        _v2v3_same(version, two_sided, layout, li, args)


def _v2v3_same(version, two_sided, layout, li, args):
    kernel, plain = ((window_v2.window_v2, window_v2.window_v2_plain)
                     if version == 2 else
                     (window_v3.window_v3, window_v3.window_v3_plain))
    dev = li.cuda()
    kw = dict(tiles=window.tile_stack(dev)) if layout == "tiles" else {}
    before = kernel.launches
    _same(kernel(dev, *(a.cuda() for a in args), two_sided=two_sided, **kw),
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
            assert g.score == w.score          # the penalty's pow is pow_f32
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
    agree exactly."""
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
            assert g.tmpl_idx == w.tmpl_idx and g.score == w.score
            np.testing.assert_allclose(g.transform, w.transform, rtol=1e-6,
                                       atol=1e-5)


def _stair_case(seed, depth=8, q=256, c=24, l=4):
    """A stack that decreases along +x (walks run far) and candidates."""
    rng = np.random.default_rng(seed)
    base = (np.arange(q, dtype=np.float32)[::-1] * 3.0)[None, None, :]
    dt3 = np.broadcast_to(base, (depth, q, q)).copy()
    dt3 += rng.uniform(0, 0.5, (depth, q, q)).astype(np.float32)
    dt3 = np.cumsum(dt3, axis=2, dtype=np.float32)[None]
    p1 = rng.uniform(40, 120, (c, l, 2)).astype(np.float32)
    d = rng.uniform(-12, 12, (c, l, 2)).astype(np.float32)
    cand = np.concatenate([p1, p1 + d], axis=-1)[None]
    ang = rng.uniform(-0.8, 0.8, c).astype(np.float32)
    align = np.stack([np.cos(ang), np.sin(ang)], axis=-1)[None]
    return (dt3, tfm.make_angles(depth), np.zeros((1, 2), np.float32),
            np.asarray([[q, q]], np.float32), cand, np.ones((1, c, l), bool),
            align)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_dense_cuda_matches_cpu(monkeypatch, version):
    """DenseOptimize on K1 at every generation: one one-lane call, then
    four 64-lane calls per direction for 256 steps; CUDA equals CPU."""
    from openfdcm_tpu_torch.matching import optimize_kernel as tok
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    inputs = _stair_case(13)
    out = {}
    for dev in ("cuda", "cpu"):
        before = window.window_scores.launches
        out[dev] = tok.optimize_candidates_batch_kernel(
            *(torch.as_tensor(a, device=dev) for a in inputs), mode="dense",
            window=1, dense_steps=256)
        out[dev + "_k1"] = window.window_scores.launches - before
    for g, w in zip(out["cuda"], out["cpu"]):
        _same(g, w)
    assert (out["cuda_k1"], out["cpu_k1"]) == (1 + 2 * 4, 0)
    assert out["cpu"][1].abs().max() > 100


def test_single_scene_build_350_cuda_matches_cpu(tmp_path, monkeypatch):
    """``build_featuremap(pad_to=None)`` on a 350-px canvas (K2, K3 and K4
    once each) equals the CPU build; ``search`` at generations 2 (K5), 3
    (the canvas gate sends it to K1) and 4, ``evaluate`` and a save/load
    round trip equal the CPU's."""
    rng = np.random.default_rng(6)
    base = rng.uniform(0, 60, (9, 4)).astype(np.float32)
    scene = np.concatenate([base + 20, rng.uniform(0, 100, (8, 4))]).astype(np.float32)
    params = ot.Dt3Params(8, 5.0, 3.61, ot.Distance.L2)
    kernels = (minplus.minplus_rows, prop.propagate_orientation, integral.sweep_stack)
    before = [k.launches for k in kernels]
    fm = ot.build_featuremap(scene, params, pad_to=None, device="cuda")
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    ref = ot.build_featuremap(scene, params, pad_to=None, device="cpu")
    assert fm.dt3.shape[-2:] == (350, 350)
    _same(fm.dt3, ref.dt3)
    templates = [base, base[:5] * np.float32(0.8)]
    main_pass = {2: window_v2.window_v2, 3: window.window_scores,
                 4: window.window_scores}
    for version in (2, 3, 4):
        monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
        before = {k: k.launches for k in (window.window_scores,
                                          window_v2.window_v2, window_v3.window_v3)}
        got = ot.search(ot.DefaultMatch(), ot.DefaultSearch(3, 5),
                        ot.BatchOptimize(5), fm, templates, scene)
        ran = {k for k, n in before.items() if k.launches > n}
        assert main_pass[version] in ran and window_v3.window_v3 not in ran
        want = ot.search(ot.DefaultMatch(), ot.DefaultSearch(3, 5),
                         ot.BatchOptimize(5), ref, templates, scene)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g.tmpl_idx, g.score) == (w.tmpl_idx, w.score)
            np.testing.assert_array_equal(g.transform, w.transform)
    trs = [[np.asarray([1.0, 2.0]), np.asarray([-300.0, 40.0])]]
    assert ot.evaluate(fm, templates[:1], trs) == ot.evaluate(ref, templates[:1], trs)
    ot.save_featuremap(str(tmp_path / "fm.npz"), fm)
    back = ot.load_featuremap(str(tmp_path / "fm.npz"), device="cuda")
    _same(back.dt3, fm.dt3)


def test_host_ranking_and_dense_cuda_match_cpu():
    """``match_many`` without ``top_k`` (every valid match, penalized on the
    host) and with DenseOptimize: CUDA equals CPU exactly."""
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 60, (7, 4)).astype(np.float32)
    templates = [base, base[:5] * np.float32(0.8)]
    scenes = [np.concatenate([base + 20, rng.uniform(0, 100, (8, 4))]).astype(np.float32)]
    args = (scenes, templates, ot.Dt3Params(8, 5.0, 1.5, ot.Distance.L2),
            ot.DefaultSearch(3, 5))
    for optimizer, top_k in ((ot.BatchOptimize(5), None), (ot.DenseOptimize(), 6)):
        kw = dict(penalty=ot.ExponentialPenalty(1.5), top_k=top_k)
        got = ot.match_many(*args, optimizer, device="cuda", **kw)
        want = ot.match_many(*args, optimizer, device="cpu", **kw)
        for g_list, w_list in zip(got, want):
            assert len(g_list) == len(w_list) > 0
            for g, w in zip(g_list, w_list):
                assert (g.tmpl_idx, g.score) == (w.tmpl_idx, w.score)
                np.testing.assert_allclose(g.transform, w.transform, rtol=1e-6,
                                           atol=1e-5)


def _serving_case():
    rng = np.random.default_rng(14)
    base = rng.uniform(0, 60, (7, 4)).astype(np.float32)
    templates = [base, base[:5] * np.float32(0.8), base[2:] * np.float32(1.1)]
    scenes = [np.concatenate([t + 20 + 5 * i, rng.uniform(0, 100, (8, 4))]).astype(np.float32)
              for i, t in enumerate(templates * 2)]
    return templates, scenes


def test_serving_cuda_equals_direct_calls():
    """``MatcherService`` on the card: concurrent requests equal a direct
    ``match_many`` on the card exactly, and the CPU's."""
    import threading
    templates, scenes = _serving_case()
    params = ot.Dt3Params(8, 5.0, 1.5, ot.Distance.L2)
    kw = dict(penalty=ot.ExponentialPenalty(1.5), top_k=5)
    args = (params, ot.DefaultSearch(3, 5), ot.BatchOptimize(5))
    direct = ot.match_many(scenes, templates, *args, device="cuda", **kw)
    cpu = ot.match_many(scenes, templates, *args, device="cpu", **kw)
    out = [None] * len(scenes)
    with ot.MatcherService(templates, *args, max_batch_delay_s=0.02,
                           device="cuda", **kw) as svc:
        svc.warmup(scenes[:1])
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, svc.match(scenes[i], timeout=300))) for i in range(len(scenes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for got, want, ref in zip(out, direct, cpu):
        assert len(got) == len(want) == len(ref) > 0
        for g, w, r in zip(got, want, ref):
            assert (g.tmpl_idx, g.score) == (w.tmpl_idx, w.score) == (r.tmpl_idx, r.score)
            np.testing.assert_array_equal(g.transform, w.transform)


def test_multiview_vote_cuda_matches_cpu():
    from openfdcm_tpu_torch import pose
    rng = np.random.default_rng(15)
    v, k = 4, 10
    cams = [pose.Camera(np.asarray([[500, 0, 0], [0, 500, 0], [0, 0, 1]], np.float32),
                        np.eye(3, dtype=np.float32),
                        np.asarray([-20.0 * i, 0, 500], np.float32)) for i in range(v)]
    objs = rng.uniform(-60, 60, (4, 3)).astype(np.float32)
    objs[:, 2] = 0
    centers = rng.uniform(-200, 200, (v, k, 2)).astype(np.float32)
    tidx = rng.integers(0, 6, (v, k)).astype(np.int32)
    valid = rng.uniform(size=(v, k)) < 0.9
    kk, rr, tt = (np.stack([getattr(c, n) for c in cams]) for n in ("k", "r", "t"))
    for vi in range(v):
        cam = objs @ rr[vi].T + tt[vi]
        pix = cam[:, :2] * 500 / cam[:, 2:]
        centers[vi, :4] = pix + rng.normal(0, 0.5, (4, 2))
        tidx[vi, :4], valid[vi, :4] = np.arange(4), True
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = [x.cpu().numpy() for x in pose.multiview_vote(
            *(torch.as_tensor(a, device=dev) for a in (centers, tidx, valid, kk, rr, tt)),
            eps_px=6.0)]
    g, w = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(g[3], w[3])
    assert w[1].max() == 4
    voted = w[1] > 0
    np.testing.assert_allclose(g[0][voted], w[0][voted], atol=1e-3)
    np.testing.assert_allclose(g[2][voted], w[2][voted], atol=1e-3)


def test_compat_cuda_featuremap_matches_cpu():
    import openfdcm_tpu_torch.compat as openfdcm
    rng = np.random.default_rng(16)
    tmpl = rng.uniform(0, 60, (10, 4)).astype(np.float32)
    scene = np.concatenate([tmpl + 30, rng.uniform(0, 120, (10, 4))]).astype(np.float32)
    params = openfdcm.Dt3CpuParameters(8, 5.0, 2.2, openfdcm.distance.L2)
    fm = {d: openfdcm.build_cpu_featuremap(scene.T, params, device=d) for d in ("cuda", "cpu")}
    gm, cm = fm["cuda"].get_dt3_map(), fm["cpu"].get_dt3_map()
    assert list(gm) == list(cm)
    for a in gm:
        assert isinstance(gm[a], np.ndarray)
        np.testing.assert_array_equal(gm[a], cm[a])
    np.testing.assert_array_equal(fm["cuda"].get_scene_translation(),
                                  fm["cpu"].get_scene_translation())
    res = {d: openfdcm.sort_matches(openfdcm.search(
        openfdcm.DefaultMatch(), openfdcm.DefaultSearch(4, 10),
        openfdcm.DefaultOptimize(), fm[d], [tmpl], scene)) for d in fm}
    assert len(res["cuda"]) == len(res["cpu"]) > 0
    for g, c in zip(res["cuda"], res["cpu"]):
        assert (g.tmpl_idx, g.score) == (c.tmpl_idx, c.score)


def test_budget_unchanged_by_the_allocator_cache():
    """A freed 4 GiB block stays in PyTorch's cache; the dispatch budget
    counts it as free, so it does not shrink."""
    from openfdcm_tpu_torch.matching import pipeline
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    before = pipeline._budget(dev)
    x = torch.empty(1 << 30, dtype=torch.float32, device=dev)
    del x
    after = pipeline._budget(dev)
    assert abs(after - before) < (64 << 20) // 4


def _two_scene_problem():
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 60, (7, 4)).astype(np.float32)
    templates = [base, base[:5] * np.float32(0.8)]
    scenes = [np.concatenate([base + 20, rng.uniform(0, 100, (8, 4))]).astype(np.float32),
              np.concatenate([base[:5] * 0.8 + 30, rng.uniform(0, 100, (8, 4))]).astype(np.float32),
              np.concatenate([base + 9, rng.uniform(0, 100, (5, 4))]).astype(np.float32)]
    return scenes, templates


def test_scene_mesh_on_one_card_equals_unsharded():
    """A ``("scene", 2)`` mesh of two ``cuda:0`` entries: the build is
    bit-equal to the unsharded CUDA build and ``match_many`` returns its
    rows exactly, with K1-K4 launched on the shards."""
    from openfdcm_tpu_torch.parallel import make_mesh
    scenes, templates = _two_scene_problem()
    params = ot.Dt3Params(8, 5.0, 1.5, ot.Distance.L2)
    mesh = make_mesh((2,), ("scene",), devices=[torch.device("cuda", 0)] * 2)
    ref = ot.build_featuremap_batch(scenes, params, device="cuda")
    before = (minplus.minplus_rows.launches, prop.propagate_orientation.launches,
              integral.sweep_stack.launches, window.window_scores.launches)
    sh = ot.build_featuremap_batch(scenes, params, mesh=mesh)
    assert torch.equal(sh.dt3, ref.dt3)
    args = (scenes, templates, params, ot.DefaultSearch(3, 5), ot.BatchOptimize(5))
    kw = dict(penalty=ot.ExponentialPenalty(1.5), top_k=6)
    got = ot.match_many(*args, mesh=mesh, **kw)
    after = (minplus.minplus_rows.launches, prop.propagate_orientation.launches,
             integral.sweep_stack.launches, window.window_scores.launches)
    assert all(a >= b + 2 for a, b in zip(after, before))
    want = ot.match_many(*args, device="cuda", **kw)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            assert (g.tmpl_idx, g.score) == (w.tmpl_idx, w.score)
            np.testing.assert_array_equal(g.transform, w.transform)


def test_row_mesh_on_one_card_equals_unsharded():
    """A ``("rows", 2)`` spatial build on two ``cuda:0`` entries (K2 and K3
    per row block) is bit-equal to the unsharded CUDA build."""
    from openfdcm_tpu_torch.parallel import build_featuremap_spatial, make_mesh
    scenes, _ = _two_scene_problem()
    mesh = make_mesh((2,), ("rows",), devices=[torch.device("cuda", 0)] * 2)
    for metric in (ot.Distance.L2, ot.Distance.L1):
        params = ot.Dt3Params(8, 5.0, 1.5, metric)
        ref = ot.build_featuremap(scenes[0], params, device="cuda")
        before = (minplus.minplus_rows.launches, prop.propagate_orientation.launches)
        sp = build_featuremap_spatial(scenes[0], params, mesh=mesh)
        w, h = ref.feature_size
        assert torch.equal(sp.dt3.gather()[:, :h, :w], ref.dt3[:, :h, :w])
        assert prop.propagate_orientation.launches == before[1] + 2
        if metric == ot.Distance.L2:
            assert minplus.minplus_rows.launches == before[0] + 2


def _photo_lines(seed, n=400, w=1920, h=1080):
    """``n`` random lines on a ``w x h`` scene, a few leaving it."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n, 2)) * (w, h)
    d = rng.uniform(-80, 80, (n, 2))
    return np.concatenate([c - d, c + d], axis=1).astype(np.float32)


@pytest.mark.parametrize("metric", [ot.Distance.L1, ot.Distance.L2,
                                    ot.Distance.L2_SQUARED])
def test_distance_transform_cuda_matches_cpu(metric):
    """The single-image DT of a 1920 x 1080 scene on the card (K2 for L2
    and L2²) against the CPU, bit for bit."""
    from openfdcm_tpu_torch.core import dt
    lines = _photo_lines(0)
    before = minplus.minplus_rows.launches
    got = dt.distance_transform(lines, (1920, 1080), metric)
    assert got.device.type == "cuda" and got.shape == (1080, 1920)
    assert minplus.minplus_rows.launches == before + (metric != ot.Distance.L1)
    _same(got, dt.distance_transform(lines, (1920, 1080), metric, device="cpu"))


def test_line_integral_cuda_matches_cpu():
    """``line_integral`` of a 1080 x 1920 image at the edge angles, one K4
    launch each, against the CPU; the input is left as it was."""
    from openfdcm_tpu_torch.core import integral as core_integral
    img = torch.as_tensor(np.random.default_rng(1).uniform(0, 9, (1080, 1920))
                          .astype(np.float32))
    dev = img.cuda()
    for angle in (0.0, np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-6, 2.9):
        before = integral.sweep_stack.launches
        got = core_integral.line_integral(dev, angle)
        assert integral.sweep_stack.launches == before + 1
        _same(got, core_integral.line_integral(img, angle))
    _same(dev, img)


def test_orientation_helpers_cuda_match_cpu():
    angles = tfm.make_angles(30)
    theta = np.random.default_rng(2).uniform(-7, 7, 100_000).astype(np.float32)
    theta[:3] = (np.nan, np.inf, -np.inf)
    got = tfm.closest_orientation_idx(torch.as_tensor(angles, device="cuda"),
                                      torch.as_tensor(theta, device="cuda"))
    _same(got, tfm.closest_orientation_idx(angles, torch.as_tensor(theta)))
    dt3 = np.random.default_rng(3).uniform(0, 50, (30, 64, 96)).astype(np.float32)
    wmat = tfm.propagation_weights(angles, 5.0)
    _same(tfm.propagate_orientation(torch.as_tensor(dt3, device="cuda"), wmat),
          tfm.propagate_orientation(torch.as_tensor(dt3), wmat))


def test_div_cr_sqrt_cr_cuda_are_ieee():
    from openfdcm_tpu_torch.core import geometry as geo
    bits = np.random.default_rng(4).integers(0, 2 ** 32, (2, 1_000_000), dtype=np.uint64)
    a, b = bits.astype(np.uint32).view(np.float32)
    with np.errstate(all="ignore"):
        want_q, want_r = a / b, np.sqrt(np.abs(a))
    _same(geo.div_cr(torch.as_tensor(a, device="cuda"), torch.as_tensor(b, device="cuda")),
          torch.as_tensor(want_q))
    _same(geo.sqrt_cr(torch.as_tensor(np.abs(a), device="cuda")), torch.as_tensor(want_r))


@pytest.mark.parametrize("version", [4, 3, 2])
def test_optimize_candidates_cuda_matches_cpu(version, monkeypatch):
    """``optimize_candidates`` on one scene's candidates at each window
    generation (K1, K6, K5 on the card) against the CPU."""
    from openfdcm_tpu_torch.matching import optimize as topt
    from openfdcm_tpu_torch.matching.match import _bucket, _scene_candidates
    from openfdcm_tpu_torch.matching.pipeline import _bank_pairs_for_scene
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    scenes, templates = _two_scene_problem()
    params = ot.Dt3Params(8, 5.0, 1.5, ot.Distance.L2)
    kernel = {4: window.window_scores, 3: window_v3.window_v3, 2: window_v2.window_v2}
    for dev in ("cuda", "cpu"):
        fm = ot.build_featuremap(scenes[0], params, pad_to=256, device=dev)
        bank = ot.prepare_templates(templates, device=dev)
        pairs = _bank_pairs_for_scene(ot.DefaultSearch(3, 5), bank, scenes[0])
        lines, mask, align, _, _ = _scene_candidates(bank, pairs, scenes[0],
                                                     _bucket(pairs.shape[0], 64))
        w, h = fm.feature_size
        before = kernel[version].launches
        out = topt.optimize_candidates(
            fm.dt3.reshape(-1), fm.angles, fm.scene_translation, fm.dt3.shape[1:],
            np.float32([w, h]), lines, mask, align, mode="default", window=32,
            dense_steps=1)
        if dev == "cuda":
            assert kernel[version].launches > before
            got = out
    for g, c in zip(got, out):
        _same(g, c)


def test_native_runtime_on_the_card_host(tmp_path):
    """The native codec, loader and pairs on the card's host against the
    port's plain versions."""
    from openfdcm_tpu_torch import native
    from openfdcm_tpu_torch.core import io
    from openfdcm_tpu_torch.matching import search
    rng = np.random.default_rng(5)
    paths = []
    for i in range(20):
        lines = rng.uniform(-500, 500, (i + 1, 4)).astype(np.float32)
        p = tmp_path / f"f{i:02d}.tmpl"
        io.write(str(p), lines, compress=bool(i % 2))
        paths.append(p)
        assert io.read_plain(str(p)).tobytes() == lines.tobytes()
    for threads in (1, 8):
        got = io.read_batch(paths, num_threads=threads)
        assert all(a.tobytes() == b.tobytes()
                   for a, b in zip(got, io.read_batch_plain(paths)))
    tl = rng.uniform(0, 100, 30).astype(np.float32)
    sl = rng.uniform(0, 100, 60).astype(np.float32)
    sl[1] = sl[0]
    np.testing.assert_array_equal(
        search._pair_by_length(tl, sl, np.arange(60), 4, 10),
        search._pair_by_length_plain(tl, sl, np.arange(60), 4, 10))
    assert native.library_path().exists()


def _launch_counts():
    return (prop.propagate_orientation.launches,
            prop.propagate_orientation_shared.launches,
            prop.propagate_orientation_global.launches)


@pytest.mark.parametrize("depth,n_steps,kind", [
    (97, None, "shared"), (180, None, "shared"), (30, 500, "shared"),
    (prop.MAX_SHARED_DEPTH, None, "shared"),
    (prop.MAX_SHARED_DEPTH + 1, None, "global"), (12, 5000, "shared")])
def test_prop_table_variants_bit_equal(depth, n_steps, kind):
    """K3 beyond its parameter table: ``propagate_orientation`` picks the
    variant :func:`variant` names (only its launch counter moves), in
    place, bit-equal to the plain version, NaN propagating."""
    rng = np.random.default_rng(depth)
    h, w = (40, 72) if depth < 1000 else (5, 7)
    x = torch.as_tensor(rng.uniform(0, 100, (2, depth, h, w)).astype(np.float32))
    x[1, 3, 2, 1] = float("nan")
    if n_steps is None:
        steps = tfm.propagation_steps(tfm.make_angles(depth), 5.0)
    else:
        c = rng.integers(0, depth, (n_steps, 2))
        steps = [(int(a), int(b), float(v))
                 for (a, b), v in zip(c, rng.uniform(0, 3, n_steps))]
    assert prop.variant(depth, len(steps)) == kind
    before = _launch_counts()
    dev = x.cuda()
    assert prop.propagate_orientation(dev, steps) is dev
    moved = [a - b for a, b in zip(_launch_counts(), before)]
    assert moved == [0, int(kind == "shared"), int(kind == "global")]
    _same(dev, prop.propagate_orientation_plain(x, steps))


def test_prop_global_any_depth_bit_equal():
    """``prop_global`` called directly at a depth the other kernels take."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.uniform(0, 100, (3, 30, 17, 23)).astype(np.float32))
    steps = tfm.propagation_steps(tfm.make_angles(30), 5.0)
    before = prop.propagate_orientation_global.launches
    _same(prop.propagate_orientation_global(x.cuda(), steps),
          prop.propagate_orientation_plain(x, steps))
    assert prop.propagate_orientation_global.launches == before + 1


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("shape", [(3, 40, 16400), (16400, 40), (2, 9, 20000)])
def test_minplus_wide_bit_equal(shape, sqrt):
    """K2 on canvases with a side above 16384: ``minplus_rows`` runs the
    64-bit variant (only its counter moves), bit-equal to the plain
    version, with pixels far beyond 2^12 px of their nearest seed."""
    g = _column_pass(2, shape, 3e-4)
    if shape[-1] > 16384:
        g[..., 0, :] = F32_MAX
        g[..., 0, 3] = 7.0                  # one seed at the row's start
    before = (minplus.minplus_rows.launches, minplus.minplus_rows_wide.launches)
    got = minplus.minplus_rows(g, sqrt=sqrt)
    after = (minplus.minplus_rows.launches, minplus.minplus_rows_wide.launches)
    assert after == (before[0], before[1] + 1)
    _same(got, minplus.minplus_rows_plain(g, sqrt=sqrt))


def test_minplus_narrow_sides_keep_the_32_bit_kernel():
    g = _column_pass(3, (16384, 24), 1e-3)
    before = (minplus.minplus_rows.launches, minplus.minplus_rows_wide.launches)
    _same(minplus.minplus_rows(g, sqrt=True), minplus.minplus_rows_plain(g, sqrt=True))
    assert (minplus.minplus_rows.launches,
            minplus.minplus_rows_wide.launches) == (before[0] + 1, before[1])


def test_optimize_candidates_take_fn_cuda_matches_cpu(monkeypatch):
    """``optimize_candidates(take_fn=clamped gather)`` on the card: equal to
    the CPU bit for bit, and to the ``take_fn=None`` call (K1) within rel
    3e-7 (the plain windows sum in K1's line order)."""
    from openfdcm_tpu_torch.matching import optimize as topt
    from openfdcm_tpu_torch.matching.match import _bucket, _scene_candidates
    from openfdcm_tpu_torch.matching.pipeline import _bank_pairs_for_scene
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", "4")
    scenes, templates = _two_scene_problem()
    params = ot.Dt3Params(8, 5.0, 1.5, ot.Distance.L2)
    out = {}
    for dev in ("cuda", "cpu"):
        fm = ot.build_featuremap(scenes[0], params, pad_to=256, device=dev)
        bank = ot.prepare_templates(templates, device=dev)
        pairs = _bank_pairs_for_scene(ot.DefaultSearch(3, 5), bank, scenes[0])
        lines, mask, align, _, _ = _scene_candidates(
            bank, pairs, scenes[0], _bucket(pairs.shape[0], 64))
        n = fm.dt3.numel()
        args = (fm.dt3.reshape(-1), fm.angles, fm.scene_translation,
                tuple(fm.dt3.shape[1:]), np.float32(fm.feature_size), lines,
                mask, align)
        kw = dict(mode="batch", window=10, dense_steps=1)
        out[dev] = topt.optimize_candidates(
            *args, **kw, take_fn=lambda f, i: f[i.clamp(0, n - 1)])
        if dev == "cuda":
            out["kernel"] = topt.optimize_candidates(*args, **kw)
    for g, c in zip(out["cuda"], out["cpu"]):
        _same(g, c)
    valid = out["cuda"][2]
    assert torch.equal(valid, out["kernel"][2]) and bool(valid.any())
    torch.testing.assert_close(out["cuda"][0][valid], out["kernel"][0][valid],
                               rtol=3e-7, atol=0)


@pytest.mark.parametrize("kind,n,variant,ahead", [
    ("revisit", 300, "param", 2), ("revisit", 500, "shared", 2),
    ("self", 1, "param", 8), ("self", 4, "shared", 8)])
def test_prop_adversarial_lists_bit_equal(kind, n, variant, ahead):
    """Step lists that revisit an index 2 steps after writing it, or read
    and write one index in a step, on ``prop_any`` (at most 384 steps) and
    ``prop_shared`` (more), and on ``prop_global`` called directly:
    in place, bit-equal to the plain chain, NaN propagating, each launched
    where :func:`prop.variant` sends the list."""
    depth = 30
    steps = revisit_steps(depth, n, 11) if kind == "revisit" else self_steps(depth, n)
    assert prop.read_ahead(steps) == ahead
    assert prop.variant(depth, len(steps)) == variant
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.uniform(0, 100, (2, depth, 40, 72)).astype(np.float32))
    x[1, 3, 2, 1] = float("nan")
    want = prop.propagate_orientation_plain(x, steps)
    before = _launch_counts() + (prop.propagate_orientation.any_launches,)
    dev = x.cuda()
    assert prop.propagate_orientation(dev, steps) is dev
    after = _launch_counts() + (prop.propagate_orientation.any_launches,)
    moved = [a - b for a, b in zip(after, before)]
    param = int(variant == "param")
    assert moved == [param, int(variant == "shared"), 0, param]
    _same(dev, want)
    _same(prop.propagate_orientation_global(x.cuda(), steps), want)


@pytest.mark.parametrize("depth,w", [(36, 70), (90, 71)])
def test_prop_any_build_depths_bit_equal(depth, w):
    """Depths a user may choose (36 or 90 bins), the reference pattern
    without an unrolled instantiation: ``prop_any``, read 8 steps ahead,
    two pixels a thread on an even canvas, one on an odd one."""
    rng = np.random.default_rng(depth)
    x = torch.as_tensor(rng.uniform(0, 100, (3, depth, 33, w)).astype(np.float32))
    steps = tfm.propagation_steps(tfm.make_angles(depth), 5.0)
    assert prop.variant(depth, len(steps)) == "param"
    assert prop.read_ahead(steps) == 8
    dev = x.cuda()
    before = _launch_counts() + (prop.propagate_orientation.any_launches,)
    assert prop.propagate_orientation(dev, steps) is dev
    after = _launch_counts() + (prop.propagate_orientation.any_launches,)
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 1]
    _same(dev, prop.propagate_orientation_plain(x, steps))
    # the reference pattern at depth 30 runs prop_fixed: no prop_any launch
    x30 = torch.rand((1, 30, 8, 10), device="cuda")
    before = prop.propagate_orientation.any_launches
    prop.propagate_orientation(x30, tfm.propagation_steps(tfm.make_angles(30), 5.0))
    assert prop.propagate_orientation.any_launches == before


def _far_column_pass(seed, shape, axis, reach, density=2e-3):
    """Column-pass distances of a seeded seed image whose seeds all lie
    below ``reach`` along ``axis`` (-1: x, -2: y), on the card: the pixels
    beyond ``reach + 4096`` are far (2^12 px or more from every seed)."""
    rng = np.random.default_rng(seed)
    ind = np.where(rng.uniform(size=shape) < density, 0.0, F32_MAX).astype(np.float32)
    far = [slice(None)] * len(shape)
    far[axis] = slice(reach, None)
    ind[tuple(far)] = F32_MAX
    return _nearest_1d_l1(torch.as_tensor(ind, device="cuda"), dim=-2)


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("shape,axis", [((2, 40, 12000), -1), ((12000, 40), -2)])
def test_minplus_narrow_far_pixels_bit_equal(shape, axis, sqrt):
    """The 32-bit K2 on canvases with pixels 2^12 px or more from every
    seed: the envelope marks them (the wide rows' right end; on the tall
    canvas, whole rows), one far-pass launch scans their bands, bit-equal
    to the plain version."""
    g = _far_column_pass(5, shape, axis, 6000)
    out = minplus.envelope(g, sqrt=sqrt)[0]
    pixels, candidates, _ = minplus.far_work(out)
    assert pixels > 0 and candidates > pixels
    if axis == -2:                              # rows with every pixel far
        assert bool(minplus.far_marks(out)[0].all(dim=-1).any())
    before = (minplus.minplus_rows.launches, minplus.minplus_rows_wide.launches,
              minplus.far_pass.launches)
    got = minplus.minplus_rows(g, sqrt=sqrt)
    after = (minplus.minplus_rows.launches, minplus.minplus_rows_wide.launches,
             minplus.far_pass.launches)
    assert after == (before[0] + 1, before[1], before[2] + 1)
    _same(got, minplus.minplus_rows_plain(g, sqrt=sqrt))


@pytest.mark.parametrize("shape", [(3, 64), (2, 17000)])
def test_minplus_every_pixel_far_bit_equal(shape):
    """Rows whose every pixel is far (all column distances 5000) on both
    instances, and the far pass alone against its plain version."""
    g = torch.full(shape, 5000.0, device="cuda")
    g[0, 1] = 4097.0
    for sqrt in (False, True):
        out, far = minplus.envelope(g, sqrt=sqrt)
        assert minplus.far_work(out)[0] == g.numel()
        want = minplus.minplus_rows_plain(g, sqrt=sqrt)
        _same(minplus.far_pass_plain(g, out, far, sqrt=sqrt), want)
        before = minplus.far_pass.launches
        assert minplus.far_pass(g, out, far, sqrt=sqrt) is out
        assert minplus.far_pass.launches == before + 1
        _same(out, want)
        _same(minplus.minplus_rows(g, sqrt=sqrt), want)
