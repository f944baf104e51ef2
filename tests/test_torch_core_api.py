"""The port's single-image core API against the JAX package on the CPU:
``distance_transform`` and its seed functions, ``line_integral``, the
orientation helpers (``closest_orientation_idx``, ``propagation_weights``,
``propagate_orientation``) and the correctly rounded ``div_cr`` /
``sqrt_cr``.

Bars: bit-equal (images, weights, quotients and roots), identical
(indices).  The JAX package's row pass runs its dense
``_minplus_quadratic_rows`` here, which is exact like the port's K2 plain
version; its line integral runs its XLA scan.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfdcm_tpu.core import dt as jdt
from openfdcm_tpu.core import geometry as jgeo
from openfdcm_tpu.core import integral as jintegral
from openfdcm_tpu.matching import featuremap as jfm
from openfdcm_tpu_torch.core import dt as tdt
from openfdcm_tpu_torch.core import geometry as tgeo
from openfdcm_tpu_torch.core import integral as tintegral
from openfdcm_tpu_torch.core.types import Distance, F32_MAX
from openfdcm_tpu_torch.matching import featuremap as tfm

torch.set_num_threads(1)

METRICS = [Distance.L2, Distance.L1, Distance.L2_SQUARED]


def _dt_pair(lines, size, metric, max_points=None):
    want = np.asarray(jdt.distance_transform(lines, size, metric, max_points))
    got = tdt.distance_transform(lines, size, metric, max_points, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    return got.numpy(), want


@pytest.mark.parametrize("metric,single,line", [
    (Distance.L2, [2, 1, 0, 1], [2, 1, 0, 0, 0, 0, 1, 2]),
    (Distance.L1, [2, 1, 0, 1], [2, 1, 0, 0, 0, 0, 1, 2]),
    (Distance.L2_SQUARED, [4, 1, 0, 1], [4, 1, 0, 0, 0, 0, 1, 4]),
])
def test_distance_transform_pinned(metric, single, line):
    """The JAX package's pinned cases (``tests/test_dt.py``), bit-equal."""
    got, want = _dt_pair(np.array([[2, 0, 2, 0]], np.float32), (4, 1), metric)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.float32(single))
    got, want = _dt_pair(np.array([[2, 0, 5, 0]], np.float32), (8, 2), metric)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.float32(line))


@pytest.mark.parametrize("metric", METRICS)
def test_distance_transform_column_ramp(metric):
    got, want = _dt_pair(np.array([[0, 0, 0, 9]], np.float32), (5, 10), metric)
    np.testing.assert_array_equal(got, want)
    for i in range(5):
        assert (got[:, i] == (i * i if metric == Distance.L2_SQUARED else i)).all()


def test_distance_transform_empty():
    for size in ((4, 4), (7, 3)):
        got, want = _dt_pair(np.zeros((0, 4), np.float32), size, Distance.L2)
        assert got.shape == (size[1], size[0])
        np.testing.assert_array_equal(got, want)
        assert (got == np.float32(F32_MAX)).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("size", [(37, 64), (130, 45), (256, 96)])
def test_distance_transform_non_square_bit_equal(metric, size):
    """Random lines on a canvas with W != H (W not a multiple of 32), some
    of them leaving it, some of zero length; the reference's ``(W, H)``
    size convention; the default and a short ``max_points``."""
    w, h = size
    rng = np.random.default_rng(w * 1000 + h)
    lines = rng.uniform(-0.2, 1.2, (12, 4)).astype(np.float32) \
        * np.float32([w, h, w, h])
    lines[0, 2:] = lines[0, :2]
    for max_points in (None, 9):
        got, want = _dt_pair(lines, size, metric, max_points)
        assert got.shape == (h, w)
        np.testing.assert_array_equal(got, want)


def test_seed_functions_bit_equal():
    """``indicator_from_points`` drops masked and out-of-range seeds and
    wraps indices in ``[-size, -1]`` as the JAX package's drop-mode scatter
    does; ``distance_from_seeds`` of the same seeds, every metric."""
    rng = np.random.default_rng(3)
    h, w = 19, 33
    pts = rng.integers(-40, 45, (60, 2)).astype(np.int32)
    mask = rng.uniform(size=60) < 0.7
    want = np.asarray(jdt.indicator_from_points(jnp.asarray(pts), jnp.asarray(mask), h, w))
    got = tdt.indicator_from_points(torch.as_tensor(pts), torch.as_tensor(mask), h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).sum() > 5
    for metric in METRICS:
        want = np.asarray(jdt.distance_from_seeds(
            jnp.asarray(pts), jnp.asarray(mask), height=h, width=w, metric=metric))
        got = tdt.distance_from_seeds(torch.as_tensor(pts), torch.as_tensor(mask),
                                      height=h, width=w, metric=metric)
        np.testing.assert_array_equal(got.numpy(), want)
    none = torch.zeros(60, dtype=torch.bool)
    assert (tdt.distance_from_seeds(torch.as_tensor(pts), none, height=h, width=w,
                                    metric=Distance.L2) == F32_MAX).all()


EDGE_ANGLES = [0.0, math.pi / 2, -math.pi / 2, math.pi / 2 - 1e-6]


@pytest.mark.parametrize("shape", [(23, 41), (64, 17)])
def test_line_integral_bit_equal(shape):
    """One image, one angle: the edge angles of ``tests/test_dt.py`` and 16
    random ones (cos < 0 among them: flipped x-major sweeps), on non-square
    images; the input is left as it was."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    angles = EDGE_ANGLES + list(rng.uniform(-math.pi, math.pi, 16))
    img = rng.uniform(0, 9, shape).astype(np.float32)
    for angle in angles:
        given = torch.tensor(img)
        got = tintegral.line_integral(given, float(angle))
        want = np.asarray(jintegral.line_integral(jnp.asarray(img), float(angle)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"angle {angle}")
        np.testing.assert_array_equal(given.numpy(), img)


def test_line_integral_pinned():
    """``tests/test_dt.py``'s exact sums, through the port."""
    ones = lambda h, w: torch.ones((h, w), dtype=torch.float32)
    np.testing.assert_array_equal(tintegral.line_integral(ones(3, 6), 0.0).numpy(),
                                  np.cumsum(np.ones((3, 6), np.float32), axis=1))
    np.testing.assert_array_equal(
        tintegral.line_integral(ones(6, 3), math.pi / 2 - 1e-6).numpy(),
        np.cumsum(np.ones((6, 3), np.float32), axis=0))
    out = tintegral.line_integral(ones(5, 2), -math.pi / 2).numpy()
    np.testing.assert_array_equal(out[:, 0], [5, 4, 3, 2, 1])


@pytest.mark.parametrize("depth", [4, 8, 30])
@pytest.mark.parametrize("coeff", [0.5, 5.0])
def test_propagation_weights_bit_equal(depth, coeff):
    angles = jfm.make_angles(depth)
    want = jfm.propagation_weights(angles, coeff)
    got = tfm.propagation_weights(tfm.make_angles(depth), coeff)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [4, 6])
def test_propagate_orientation_bit_equal(depth):
    """Random slices, an empty (infinite) one and the closed-form case of
    ``tests/test_featuremap.py`` (a DT in slice 0, the rest infinite); the
    input is left as it was."""
    rng = np.random.default_rng(depth)
    angles = jfm.make_angles(depth)
    dt3 = rng.uniform(0, 60, (depth, 21, 34)).astype(np.float32)
    dt3[1] = np.inf
    ramp = np.asarray(jdt.distance_transform(np.array([[0, 0, 0, 39]], np.float32),
                                             (30, 40)))
    single = np.stack([ramp] + [np.full((40, 30), np.inf, np.float32)] * (depth - 1))
    for stack, coeff in ((dt3, 5.0), (single, 0.5)):
        wmat = jfm.propagation_weights(angles, coeff)
        want = np.asarray(jfm.propagate_orientation(jnp.asarray(stack), jnp.asarray(wmat)))
        given = torch.tensor(stack)
        got = tfm.propagate_orientation(given, wmat)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(given.numpy(), stack)


def _theta_cases(angles, rng):
    """Random thetas over two turns, the table's own angles and their f32
    neighbours, midpoints (interior ties), points beyond both ends and the
    wrap's tie, +-inf and NaN."""
    a = np.asarray(angles, np.float32)
    mids = ((a[:-1] + a[1:]) / np.float32(2)).astype(np.float32)
    ends = np.float32([a[0] - 0.01, a[-1] + 0.01, (a[0] + a[-1] + np.pi) / 2,
                       (a[0] + a[-1] + np.pi) / 2 + 1e-6, a[-1] + np.pi / 2,
                       a[0] - np.pi / 2])
    near = np.concatenate([np.nextafter(a, np.float32(np.inf)),
                           np.nextafter(a, np.float32(-np.inf))])
    special = np.float32([np.nan, np.inf, -np.inf, 0.0, -0.0])
    rand = rng.uniform(-2 * np.pi, 2 * np.pi, 2000).astype(np.float32)
    return np.concatenate([rand, a, mids, ends, near, special]).astype(np.float32)


@pytest.mark.parametrize("depth", [4, 8, 30])
def test_closest_orientation_idx_identical(depth):
    rng = np.random.default_rng(depth)
    custom = np.array(sorted([-math.pi / 2 + math.pi / 100, -math.pi / 4, 0.0,
                              math.pi / 4, math.pi / 2 - math.pi / 100, math.pi]),
                      np.float32)
    for angles in (jfm.make_angles(depth), custom):
        theta = _theta_cases(angles, rng)
        want = np.asarray(jfm.closest_orientation_idx(jnp.asarray(angles),
                                                      jnp.asarray(theta)))
        got = tfm.closest_orientation_idx(torch.as_tensor(angles),
                                          torch.as_tensor(theta))
        assert got.dtype == torch.int32 and got.shape == theta.shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[np.isnan(theta)].eq(len(angles) - 1).all()
        scalar = tfm.closest_orientation_idx(angles, float(theta[0]))
        assert scalar.shape == () and int(scalar) == int(want[0])


def _f32_pairs(n, seed):
    """``n`` pairs of f32 values from random bit patterns (every sign,
    exponent, subnormal, infinity and NaN)."""
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, (2, n), dtype=np.uint64)
    return bits.astype(np.uint32).view(np.float32)


def _mismatches(a, b):
    return int(((a != b) & ~(np.isnan(a) & np.isnan(b))).sum())


def test_div_cr_sqrt_cr_bit_equal():
    """1M pairs: ``div_cr`` and ``sqrt_cr`` against the JAX package's with
    0 mismatches wherever no subnormal is involved, and against numpy's
    IEEE results everywhere.  XLA:CPU flushes subnormal inputs and results
    to zero, so the JAX package's CPU values are no reference there."""
    a, b = _f32_pairs(1_000_000, 0)
    tiny = np.finfo(np.float32).tiny
    sub = lambda x: (x != 0) & (np.abs(x) < tiny)
    with np.errstate(all="ignore"):
        want_np, root_np = a / b, np.sqrt(np.abs(a))
    got = tgeo.div_cr(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jgeo.div_cr(jnp.asarray(a), jnp.asarray(b)))
    normal = ~(sub(a) | sub(b) | sub(want_np))
    assert normal.sum() > 900_000
    assert _mismatches(got[normal], want[normal]) == 0
    assert _mismatches(got, want_np) == 0
    root = tgeo.sqrt_cr(torch.as_tensor(np.abs(a))).numpy()
    want = np.asarray(jgeo.sqrt_cr(jnp.asarray(np.abs(a))))
    normal = ~sub(a)
    assert _mismatches(root[normal], want[normal]) == 0
    assert _mismatches(root, root_np) == 0
    host = tgeo.div_cr(np.float32([1.0, 2.0]), np.float32([3.0, 0.0]), device="cpu")
    np.testing.assert_array_equal(host.numpy(), np.float32([1 / 3, np.inf]))
