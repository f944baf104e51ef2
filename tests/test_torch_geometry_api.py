"""The port's geometry, utils, rasterize and draw helpers against the JAX
package on the CPU, on seeded lines with vertical, point, NaN and
out-of-canvas lines: bit-equal, except ``get_angle`` (``torch.atan``
against XLA's ``atan``: at most 1 ulp apart, stated below)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from openfdcm_tpu.core import draw as jdraw
from openfdcm_tpu.core import geometry as jgeo
from openfdcm_tpu.core import rasterize as jras
from openfdcm_tpu.core import utils as jutils
from openfdcm_tpu_torch.core import draw as tdraw
from openfdcm_tpu_torch.core import geometry as tgeo
from openfdcm_tpu_torch.core import rasterize as tras
from openfdcm_tpu_torch.core import utils as tutils

torch.set_num_threads(1)


def _lines(seed=0, n=64, lo=-40.0, hi=200.0):
    """Seeded lines plus a vertical line, a horizontal one, a point, a
    near-point (within the 1e-5 degenerate tolerance) and a NaN line."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    a[0] = [10.0, 5.0, 10.0, 90.0]
    a[1] = [3.0, 7.0, 80.0, 7.0]
    a[2] = [12.5, 12.5, 12.5, 12.5]
    a[3] = [30.0, 30.0, 30.000004, 29.999998]
    a[4] = [np.nan, 1.0, 5.0, 6.0]
    return a


def _same(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("layout", ["n4", "4n", "one"])
def test_as_lines(layout):
    a = _lines(1, n=7)
    x = {"n4": a, "4n": a.T, "one": a[5]}[layout]
    _same(tgeo.as_lines(x, device="cpu"), jgeo.as_lines(x))
    _same(tgeo.as_lines(_t(x)), jgeo.as_lines(x))
    with pytest.raises(ValueError, match="trailing"):
        tgeo.as_lines(np.zeros((3, 5)), device="cpu")


@pytest.mark.parametrize("name", ["p1", "p2", "get_center", "get_length",
                                  "normalize", "minmax_point"])
def test_line_functions_bit_equal(name):
    a = _lines(2)
    got, want = getattr(tgeo, name)(_t(a)), getattr(jgeo, name)(jnp.asarray(a))
    if name == "minmax_point":
        for g, w in zip(got, want):
            _same(g, w)
    else:
        _same(got, want)


def test_get_angle_within_one_ulp():
    """``atan(dy/dx)``: vertical lines give +-pi/2, a point NaN; the rest
    within 1 ulp of XLA's ``atan`` (the two libraries' ``atan`` may round
    differently; the matching path never calls it)."""
    a = _lines(3, n=4000)
    got = tgeo.get_angle(_t(a)).numpy()
    want = np.asarray(jgeo.get_angle(jnp.asarray(a)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    ulps = np.abs(got[ok].view(np.int32).astype(np.int64)
                  - want[ok].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert got[0] == np.float32(np.pi / 2) and np.isnan(got[2])


def test_translate_rotate_combine_bit_equal():
    """Bit-equal on finite lines.  A NaN endpoint rotates to NaN in the
    port; the JAX package's FMA-proof product (``_round_launder``) turns it
    into arbitrary bits (-inf here), as its docstring warns — a pinned
    divergence."""
    a = _lines(4)
    rng = np.random.default_rng(4)
    th = rng.uniform(-np.pi, np.pi)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    tr = rng.uniform(-30, 30, 2).astype(np.float32)
    mat = np.concatenate([rot, tr[:, None]], axis=1)
    pt = rng.uniform(0, 100, 2).astype(np.float32)
    _same(tgeo.translate(_t(a), tr), jgeo.translate(jnp.asarray(a), tr))
    fin = ~np.isnan(a).any(axis=1)
    for got, want in ((tgeo.rotate(_t(a), rot),
                       jgeo.rotate(jnp.asarray(a), jnp.asarray(rot))),
                      (tgeo.rotate(_t(a), rot, pt),
                       jgeo.rotate(jnp.asarray(a), jnp.asarray(rot), jnp.asarray(pt))),
                      (tgeo.transform(_t(a), _t(mat)),
                       jgeo.transform(jnp.asarray(a), mat))):
        _same(got[fin], np.asarray(want)[fin])
        assert got[~fin][:, :2].isnan().all()
    _same(tgeo.combine(_t(mat), _t(tr)), jgeo.combine(mat, tr))
    _same(tgeo.combine(_t(tr), _t(mat)), jgeo.combine(tr, mat))
    _same(tgeo.combine(mat, tr, device="cpu"), jgeo.combine(mat, tr))
    mats = np.stack([mat, mat * 0.5])
    trs = np.stack([tr, -tr])
    _same(tgeo.combine(_t(mats), _t(trs)), jgeo.combine(mats, trs))


def test_angle_wraps_bit_equal():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-20, 20, 500),
                        [0.0, np.pi, -np.pi, np.pi / 2, -np.pi / 2, 3 * np.pi,
                         -7.5, np.nan]]).astype(np.float32)
    _same(tgeo.constrain_half_angle(x, device="cpu"), jgeo.constrain_half_angle(x))
    _same(tgeo.constrain_angle(_t(x)), jgeo.constrain_angle(x))
    _same(tgeo.wrap_max(_t(x), 2.5), jgeo.wrap_max(jnp.asarray(x), 2.5))
    _same(tgeo.wrap_min_max(_t(x), -1.5, 4.0),
          jgeo.wrap_min_max(jnp.asarray(x), -1.5, 4.0))


def test_all_close_and_relatively_equal():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    for b, rtol, atol in ((a + 5e-6, 0.0, 1e-5), (a + 2e-5, 0.0, 1e-5),
                          (a * 1.001, 1e-2, 0.0)):
        assert tgeo.all_close(_t(a), b, rtol, atol) == jgeo.all_close(a, b, rtol, atol)
    b = a + np.float32(1e-7)
    _same(tgeo.relatively_equal(_t(a), b), jgeo.relatively_equal(a, b))


def test_utils_bit_equal():
    rng = np.random.default_rng(6)
    v = rng.integers(0, 20, 200).astype(np.float32)     # ties: stability
    for desc in (False, True):
        assert tutils.argsort(v, desc) == jutils.argsort(v, desc)
        s = np.sort(v)[::-1] if desc else np.sort(v)
        for x in (-5.0, 0.0, 3.5, 7.0, 19.0, 40.0):
            assert tutils.binary_search(s, x, desc) == jutils.binary_search(s, x, desc)


BOX = (0.0, 127.0, 0.0, 95.0)


@pytest.mark.parametrize("delete_oob", [True, False])
def test_clip_lines_bit_equal(delete_oob):
    a = _lines(7, n=300, lo=-150, hi=300)
    _same(tras.clip_lines(a, BOX, delete_oob, device="cpu"),
          jras.clip_lines(a, BOX, delete_oob))
    _same(tras.clip_lines(np.zeros((0, 4)), BOX, delete_oob, device="cpu"),
          jras.clip_lines(np.zeros((0, 4)), BOX, delete_oob))


def test_clip_lines_masked_bit_equal():
    a = _lines(8, n=200, lo=-150, hi=300)
    for g, w in zip(tras.clip_lines_masked(_t(a), BOX),
                    jras.clip_lines_masked(jnp.asarray(a), BOX)):
        _same(g, w)


def test_raster_size_and_rasterize_line_bit_equal():
    """Also NaN and far lines, whose sizes convert as XLA converts floats to
    int32 (NaN to 0, saturating): a NaN line is one point, a line longer
    than 2^31 none."""
    a = _lines(9, n=80, lo=-60, hi=120)
    far = np.array([[0, 0, 3e9, 1], [0, 0, 2.5e7, 0], [np.nan] * 4], np.float32)
    b = np.concatenate([a, far])
    _same(tras.raster_size(_t(b)), jras.raster_size(jnp.asarray(b)))
    for got, want in zip(tras.rasterize_lines_masked(_t(b), 7),
                         jras.rasterize_lines_masked(jnp.asarray(b), 7)):
        _same(got, want)
    fin = a[~np.isnan(a).any(axis=1)]
    for line in fin:
        _same(tras.rasterize_line(line, device="cpu"), jras.rasterize_line(line))


def test_seed_points_bit_equal():
    a = _lines(10, n=60, lo=-80, hi=220)
    for g, w in zip(tdraw.seed_points(_t(a), 96, 128, 160),
                    jdraw.seed_points(jnp.asarray(a), 96, 128, 160)):
        _same(g, w)


@pytest.mark.parametrize("max_points", [None, 40])
def test_draw_lines_bit_equal(max_points):
    """Lines inside, across and outside the canvas, negative coordinates,
    a point and a NaN line; the image keeps its earlier pixels."""
    a = _lines(11, n=50, lo=-120, hi=260)
    img = np.zeros((96, 128), np.float32)
    img[10:20, 30:40] = 7.0
    got = tdraw.draw_lines(_t(img), a, 3.0, max_points)
    want = jdraw.draw_lines(jnp.asarray(img), a, 3.0, max_points)
    _same(got, want)
    assert (got == 3.0).sum() > 500
    fin = a[~np.isnan(a).any(axis=1)]
    _same(tdraw.draw_lines(_t(img).to(torch.uint8), fin.T, 255),
          jdraw.draw_lines(jnp.asarray(img, jnp.uint8), fin.T, 255))
    _same(tdraw.draw_lines(_t(img), np.zeros((0, 4)), 1.0), img)
