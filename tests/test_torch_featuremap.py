"""The PyTorch port's DT3 build against the JAX package on the CPU.

Bars: orientation classes index-equal; the propagation, the line integral
and the whole DT3 stack bit-equal.  The port runs the plain versions of
kernels K2, K3 and K4 here; the JAX package runs its XLA reference paths
(its Pallas kernels are gated to the TPU).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import openfdcm_tpu as of
from openfdcm_tpu.core import integral as jintegral
from openfdcm_tpu.matching import featuremap as jfm
from openfdcm_tpu_torch.core import integral as tintegral
from openfdcm_tpu_torch.core.types import Distance
from openfdcm_tpu_torch.matching import featuremap as tfm
from openfdcm_tpu_torch.matching import pipeline as tpipe
from openfdcm_tpu_torch.ops import prop as tprop
from openfdcm_tpu_torch.ops.integral import sweep_stack_plain
from tests.torch_steps import revisit_steps, self_steps
from tests.utils import create_lines, make_rotation

torch.set_num_threads(1)


@pytest.mark.parametrize("depth", [8, 30])
def test_classify_lines_index_equal(depth):
    rng = np.random.default_rng(0)
    lines = rng.uniform(-50, 50, (400, 4)).astype(np.float32)
    special = np.array([[1, 1, 1, 9],        # vertical
                        [1, 9, 1, 1],        # vertical, reversed
                        [1, 1, 9, 1],        # horizontal
                        [9, 1, 1, 1],        # horizontal, reversed
                        [3, 3, 3, 3],        # zero length (NaN ratio)
                        [0, 0, 5, -5],       # 45 degrees
                        [0, 0, -5, -5]], np.float32)
    lines = np.concatenate([lines, special])
    want = np.asarray(jfm.classify_lines(jnp.asarray(jfm.make_angles(depth)),
                                         jnp.asarray(lines)))
    got = tfm.classify_lines(tfm.make_angles(depth), torch.as_tensor(lines)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-3] == depth - 1                  # NaN ratio -> last slice


def test_propagate_orientation_relax_bit_equal():
    rng = np.random.default_rng(1)
    depth = 8
    dt3 = rng.uniform(0, 50, (2, depth, 16, 24)).astype(np.float32)
    steps = jfm.propagation_steps(tuple(float(a) for a in jfm.make_angles(depth)), 5.0)
    assert steps == tfm.propagation_steps(tfm.make_angles(depth), 5.0)
    want = np.asarray(jfm.propagate_orientation_relax(jnp.asarray(dt3), steps))
    got = tfm.propagate_orientation_relax(torch.as_tensor(dt3), steps).numpy()
    np.testing.assert_array_equal(got, want)


def test_k3_reference_pattern_matches_propagation_steps():
    """The step pattern ``prop_fixed<D, V>`` unrolls at compile time
    (``csrc/prop.cu``, mirrored by ``reference_pattern``) is the port's and
    the JAX package's schedule at every depth the kernel takes, and its
    length fits the kernel's parameter block."""
    for depth in range(1, tprop.MAX_DEPTH + 1):
        angles = tfm.make_angles(depth)
        port = tfm.propagation_steps(angles, 5.0)
        jax_steps = jfm.propagation_steps(tuple(float(a) for a in angles), 5.0)
        assert [(a, b) for a, b, _ in port] == tprop.reference_pattern(depth)
        assert [(a, b) for a, b, _ in jax_steps] == tprop.reference_pattern(depth)
        assert len(port) == 4 * depth <= tprop.MAX_STEPS


def k3_mirror(dt3: np.ndarray, weights, depth: int, pixels: int) -> np.ndarray:
    """``prop_fixed<depth, pixels>`` on a host copy: thread ``p`` of stack
    ``p // (HW / V)`` holds pixels ``V (p % (HW / V)) + j``; the unrolled
    forward then backward steps with the NaN-propagating min, in f32."""
    *lead, d, h, w = dt3.shape
    hw = h * w
    flat = dt3.reshape(-1, d, hw).copy()
    p = np.arange(flat.shape[0] * hw // pixels)
    st, grp = np.divmod(p, hw // pixels)
    visits = np.zeros((flat.shape[0], hw), np.int64)
    for j in range(pixels):
        pix = pixels * grp + j
        np.add.at(visits, (st, pix), 1)
        v = flat[st, :, pix].T.copy()                      # (D, threads)
        for (a, b), wgt in zip(tprop.reference_pattern(depth), weights):
            cand = v[a] + np.float32(wgt)
            v[b] = np.where((cand < v[b]) | np.isnan(cand), cand, v[b])
        flat[st, :, pix] = v.T
    assert (visits == 1).all()
    return flat.reshape(dt3.shape)


@pytest.mark.parametrize("depth,h,w,pixels", [(12, 10, 14, 2), (30, 16, 24, 2),
                                              (30, 7, 9, 1), (60, 6, 8, 1)])
def test_k3_mirror_and_in_place_wrapper(depth, h, w, pixels):
    """The mirror of the unrolled kernel, the in-place wrapper (its return
    value is its input) and the JAX package agree bit for bit, NaN
    included."""
    rng = np.random.default_rng(depth + h)
    dt3 = rng.uniform(0, 60, (2, depth, h, w)).astype(np.float32)
    dt3[1, 2, 3, 4] = np.nan
    steps = tfm.propagation_steps(tfm.make_angles(depth), 5.0)
    want = np.asarray(jfm.propagate_orientation_relax(jnp.asarray(dt3), steps))
    got = k3_mirror(dt3, [s[2] for s in steps], depth, pixels)
    np.testing.assert_array_equal(got, want)
    x = torch.tensor(dt3)
    assert tprop.propagate_orientation(x, steps) is x
    np.testing.assert_array_equal(x.numpy(), want)


def test_k3_other_step_lists_in_place():
    """A step list that is not the reference pattern (the general kernel's
    case), and one longer than its 384 steps (the device-table kernels'),
    runs the plain chain, in place, on the CPU too."""
    rng = np.random.default_rng(3)
    dt3 = rng.uniform(0, 60, (7, 5, 6)).astype(np.float32)
    steps = tfm.propagation_steps(tfm.make_angles(7), 2.0)[::-1]
    for chain in (steps, steps * 14):
        want = tprop.propagate_orientation_plain(torch.tensor(dt3), chain)
        x = torch.tensor(dt3)
        assert tprop.propagate_orientation(x, chain) is x
        np.testing.assert_array_equal(x.numpy(), want.numpy())
    assert tprop.variant(7, len(steps * 14)) == "shared"


def test_k3_chain_flags_and_read_ahead_of_the_builds():
    """The read-ahead plan of every build's step list (the port's and the
    JAX package's, the same list): every step but the first and at most one
    more is chained (reads the index the step before it wrote), the least
    revisit distance is at least D/2 - 1, so the kernels read 8 steps ahead
    from depth 18 on."""
    for depth in list(range(1, 200)) + [1817]:
        angles = tfm.make_angles(depth)
        port = tfm.propagation_steps(angles, 5.0)
        if depth <= 100:
            jax_steps = jfm.propagation_steps(tuple(float(a) for a in angles), 5.0)
            assert [s[:2] for s in jax_steps] == [s[:2] for s in port]
        c1 = np.array([s[0] for s in port])
        c2 = np.array([s[1] for s in port])
        flags = tprop.chain_flags(port)
        np.testing.assert_array_equal(flags[1:], c1[1:] == c2[:-1])
        assert not flags[0] and (~flags).sum() <= 2
        least = tprop.revisit_distance(port)
        assert least >= depth // 2 - 1
        assert tprop.read_ahead(port) == max(a for a in tprop.READ_AHEAD if a <= least)
        if depth >= 18:
            assert tprop.read_ahead(port) == 8


def k3_relax_mirror(dt3: np.ndarray, steps, ahead: int) -> np.ndarray:
    """``relax`` of ``csrc/prop.cu`` on every pixel of a host copy: step
    ``m``'s operands read from the vector right after step ``m - ahead``
    was applied (step ``m`` itself fetched a round earlier), a chained
    step's ``c1`` taken from the carry, the NaN-propagating min in f32."""
    *lead, d, h, w = dt3.shape
    v = np.moveaxis(dt3.reshape(-1, d, h * w), 1, 0).reshape(d, -1).copy()
    chain = tprop.chain_flags(steps)
    n = len(steps)

    def operands(m):
        if m >= n:
            return None
        c1, c2, wgt = steps[m]
        return v[c2].copy(), None if chain[m] else v[c1].copy()

    ring = [operands(m) for m in range(ahead)]
    carry = None
    for m in range(n):
        b, a = ring[m % ahead]
        cand = (carry if chain[m] else a) + np.float32(steps[m][2])
        carry = np.where((cand < b) | np.isnan(cand), cand, b)
        v[steps[m][1]] = carry
        ring[m % ahead] = operands(m + ahead)
    out = np.moveaxis(v.reshape(d, -1, h * w), 0, 1)
    return out.reshape(dt3.shape)


def _k3_lists():
    """Step lists with their read-ahead: the builds' pattern at depths 36
    and 90 (``prop_any``), one that revisits an index 2 steps after writing
    it, one with ``c1 == c2`` steps, a seeded random list (revisits at
    distance 1)."""
    rng = np.random.default_rng(5)
    pairs = rng.integers(0, 30, (150, 2))
    random = [(int(a), int(b), float(np.float32(x))) for (a, b), x
              in zip(pairs, rng.uniform(0, 3, 150))]
    return {"ref36": (36, tfm.propagation_steps(tfm.make_angles(36), 5.0), 8),
            "ref90": (90, tfm.propagation_steps(tfm.make_angles(90), 5.0), 8),
            "revisit": (30, revisit_steps(30, 150, 11), 2),
            "self": (30, self_steps(30), 8),
            "random": (30, random, 1)}


@pytest.mark.parametrize("case", sorted(_k3_lists()))
def test_k3_register_chain_mirror(case):
    """The mirror of the kernels' relaxation, reading ``read_ahead(steps)``
    steps ahead, equals the plain chain and the JAX package's relaxation bit
    for bit, NaN included; the wrapper in place equals both too."""
    depth, steps, ahead = _k3_lists()[case]
    assert tprop.read_ahead(steps) == ahead
    rng = np.random.default_rng(depth)
    dt3 = rng.uniform(0, 60, (2, depth, 5, 6)).astype(np.float32)
    dt3[1, 2, 3, 4] = np.nan
    want = np.asarray(jfm.propagate_orientation_relax(jnp.asarray(dt3), steps))
    np.testing.assert_array_equal(k3_relax_mirror(dt3, steps, ahead), want)
    x = torch.tensor(dt3)
    assert tprop.propagate_orientation(x, steps) is x
    np.testing.assert_array_equal(x.numpy(), want)


def test_k3_read_ahead_past_the_revisit_distance_is_stale():
    """Why the read-ahead is bounded by the least revisit distance: reading
    4 steps ahead on a list that writes an index again 2 steps after writing
    it reads values the 2 steps between have not yet written, and the
    result differs from the chain; 2 steps ahead it does not."""
    steps = revisit_steps(30, 150, 11)
    assert tprop.revisit_distance(steps) == 2
    rng = np.random.default_rng(2)
    dt3 = rng.uniform(0, 60, (1, 30, 4, 4)).astype(np.float32)
    want = tprop.propagate_orientation_plain(torch.tensor(dt3), steps).numpy()
    np.testing.assert_array_equal(k3_relax_mirror(dt3, steps, 2), want)
    assert not np.array_equal(k3_relax_mirror(dt3, steps, 4), want)


def test_line_integral_stack_bit_equal_padded_canvas():
    """Both sweep majors and both flips, on a physical canvas padded beyond
    each scene's (different) logical region.  The DT3 angle bank has no
    x-major flipped sweep (cos >= 0 on [-pi/2, pi/2)), so two angles with
    cos < 0 join it here."""
    rng = np.random.default_rng(2)
    depth, ph, pw = 8, 48, 64
    angles = np.concatenate([tfm.make_angles(6), [2.8, -2.9]]).astype(np.float32)
    lhw = np.array([[40, 50], [48, 37]], np.int64)
    _, table = tintegral.sweep_tables(angles, lhw, ph, pw)
    assert {(x, f) for x, f, _ in table.tolist()} == \
        {(1, 0), (1, 1), (0, 0), (0, 1)}
    imgs = rng.uniform(0, 9, (2, depth, ph, pw)).astype(np.float32)
    for i, (h, w) in enumerate(lhw):
        imgs[i, :, h:, :] = 0.0
        imgs[i, :, :, w:] = 0.0
    # the integral is taken in place: hand the port a copy
    got = tintegral.line_integral_stack_batch_(torch.tensor(imgs), angles, lhw).numpy()
    for i in range(2):
        want = np.asarray(jintegral.line_integral_stack(
            jnp.asarray(imgs[i]), list(angles), logical_hw=lhw[i]))
        np.testing.assert_array_equal(got[i], want)


def k4_mirror(imgs: np.ndarray, deltas: np.ndarray, table: np.ndarray):
    """``csrc/integral.cu`` (sweep_paths_kernel) on a host copy: per slice,
    one carry per path ``u = y - D_k`` (``D_k`` the cumulative shift up to
    sweep position ``k``, inclusive; a delta outside {-1, +1} shifts by 0),
    over ``u in [-max D, rows - 1 - min D]``; a path adds its cell to its
    carry, or to 0 where it just entered the canvas."""
    s, d, ph, pw = imgs.shape
    out = imgs.copy().reshape(s * d, ph, pw)
    for sl, (x_major, flip, row) in enumerate(table.tolist()):
        view = out[sl] if x_major else out[sl].T         # (rows, n) view
        rows, n = view.shape
        order = np.arange(n)[::-1] if flip else np.arange(n)
        dl = deltas[row, order]                           # by sweep position
        dk = np.cumsum((dl == 1).astype(np.int64) - (dl == -1))
        visits = np.zeros((rows, n), np.int64)
        for u in range(-dk.max(), rows - dk.min()):
            carry, prev_in = np.float32(0), False
            for k in range(n):
                y, c = u + dk[k], order[k]
                inside = 0 <= y < rows
                if inside:
                    carry = np.float32(view[y, c] + (carry if prev_in else np.float32(0)))
                    view[y, c] = carry
                    visits[y, c] += 1
                prev_in = inside
        assert (visits == 1).all()                # one path through each cell
        for k0 in range(0, n, 32):                # x-major tile: <= 64 rows
            span = dk[k0:k0 + 32]
            assert 32 + span.max() - span.min() <= 64
    return out.reshape(s, d, ph, pw)


def test_k4_mirror_matches_plain_and_jax_padded_canvas():
    """The mirror against the port's line integral and the JAX package on
    the padded canvas above: all four (x_major, flip) pairs, per-scene
    delta rows of the flipped sweeps."""
    rng = np.random.default_rng(2)
    depth, ph, pw = 8, 48, 64
    angles = np.concatenate([tfm.make_angles(6), [2.8, -2.9]]).astype(np.float32)
    lhw = np.array([[40, 50], [48, 37]], np.int64)
    deltas, table = tintegral.sweep_tables(angles, lhw, ph, pw)
    assert (deltas[table[table[:, 1] == 1, 2]] != deltas[table[0, 2]]).any()
    imgs = rng.uniform(0, 9, (2, depth, ph, pw)).astype(np.float32)
    for i, (h, w) in enumerate(lhw):
        imgs[i, :, h:, :] = 0.0
        imgs[i, :, :, w:] = 0.0
    got = k4_mirror(imgs, deltas, table)
    np.testing.assert_array_equal(
        got, tintegral.line_integral_stack_batch_(torch.tensor(imgs), angles, lhw).numpy())
    for i in range(2):
        want = np.asarray(jintegral.line_integral_stack(
            jnp.asarray(imgs[i]), list(angles), logical_hw=lhw[i]))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("x_major", [True, False])
@pytest.mark.parametrize("flip", [False, True])
def test_k4_mirror_random_deltas(x_major, flip):
    """Deltas in {-2..2} at random (paths that leave and re-enter the
    canvas; +-2 acts as 0): the mirror against the plain version and the
    JAX package's ``_sweep_scan``, slice by slice."""
    rng = np.random.default_rng(int(x_major) * 2 + int(flip))
    s, d, ph, pw = 2, 3, 24, 40
    n = pw if x_major else ph
    imgs = rng.uniform(-5, 9, (s, d, ph, pw)).astype(np.float32)
    deltas = rng.integers(-2, 3, (s * d, max(ph, pw))).astype(np.int32)
    table = np.array([(x_major, flip, i) for i in range(s * d)], np.int32)
    got = k4_mirror(imgs, deltas, table)
    plain = sweep_stack_plain(torch.tensor(imgs), deltas, table).numpy()
    np.testing.assert_array_equal(got, plain)
    for i, img in enumerate(imgs.reshape(-1, ph, pw)):
        cols = img if x_major else img.T
        want = np.asarray(jintegral._sweep_scan(jnp.asarray(cols),
                                                jnp.asarray(deltas[i, :n]), flip))
        np.testing.assert_array_equal(got.reshape(-1, ph, pw)[i],
                                      want if x_major else want.T)


def _scenes():
    tmpl = np.asarray(create_lines(8, 60))
    rng = np.random.default_rng(3)
    out = []
    for angle, shift in ((0.7, 4.0), (-0.4, 9.0)):
        rot = make_rotation(angle)
        a = (tmpl.reshape(-1, 2) @ rot.T).reshape(-1, 4) + np.float32(shift)
        clutter = rng.uniform(-20, 70, (12, 4)).astype(np.float32)
        out.append(np.concatenate([a, clutter]).astype(np.float32))
    out.append(np.array([[2.0, 3.0, 40.0, 17.0]], np.float32))   # one line
    return out


@pytest.mark.parametrize("metric", [Distance.L2, Distance.L2_SQUARED, Distance.L1])
def test_build_featuremap_batch_bit_equal(metric):
    scenes = _scenes()
    jparams = of.Dt3Params(4, 5.0, 1.5, of.Distance(int(metric)))
    want = of.build_featuremap_batch(scenes, jparams, pad_to=64)
    got = tpipe.build_featuremap_batch(scenes, tfm.Dt3Params(4, 5.0, 1.5, metric),
                                       pad_to=64, device="cpu")
    dt3 = np.asarray(want.dt3)
    assert dt3.shape == tuple(got.dt3.shape)
    # logical regions are smaller than the physical canvas
    assert any(max(w, h) < dt3.shape[-1] for w, h in want.feature_sizes)
    assert got.feature_sizes == tuple(want.feature_sizes)
    np.testing.assert_array_equal(got.dt3.numpy(), dt3)
    np.testing.assert_array_equal(got.scene_translations.numpy(),
                                  np.asarray(want.scene_translations))
    np.testing.assert_array_equal(got.angles.numpy(), np.asarray(want.angles))
