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
    got = tfm.classify_lines(depth, torch.as_tensor(lines)).numpy()
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


def test_line_integral_stack_bit_equal_padded_canvas():
    """Both sweep majors and both flips, on a physical canvas padded beyond
    each scene's (different) logical region.  The DT3 angle bank has no
    x-major flipped sweep (cos >= 0 on [-pi/2, pi/2)), so two angles with
    cos < 0 join it here."""
    rng = np.random.default_rng(2)
    depth, ph, pw = 8, 48, 64
    angles = np.concatenate([tfm.make_angles(6), [2.8, -2.9]]).astype(np.float32)
    groups = tintegral._group_geometry(angles, {True: pw, False: ph})
    assert {(x, bool(f)) for x, _, flips, _ in groups for f in flips} == \
        {(True, False), (True, True), (False, False), (False, True)}
    lhw = np.array([[40, 50], [48, 37]], np.int64)
    imgs = rng.uniform(0, 9, (2, depth, ph, pw)).astype(np.float32)
    for i, (h, w) in enumerate(lhw):
        imgs[i, :, h:, :] = 0.0
        imgs[i, :, :, w:] = 0.0
    got = tintegral.line_integral_stack(torch.as_tensor(imgs), angles, lhw).numpy()
    for i in range(2):
        want = np.asarray(jintegral.line_integral_stack(
            jnp.asarray(imgs[i]), list(angles), logical_hw=lhw[i]))
        np.testing.assert_array_equal(got[i], want)


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
                                       pad_to=64)
    dt3 = np.asarray(want.dt3)
    assert dt3.shape == tuple(got.dt3.shape)
    # logical regions are smaller than the physical canvas
    assert any(max(w, h) < dt3.shape[-1] for w, h in want.feature_sizes)
    assert got.feature_sizes == tuple(want.feature_sizes)
    np.testing.assert_array_equal(got.dt3.numpy(), dt3)
    np.testing.assert_array_equal(got.scene_translations.numpy(),
                                  np.asarray(want.scene_translations))
    np.testing.assert_array_equal(got.angles.numpy(), np.asarray(want.angles))
