"""The port's candidate-level optimizer entry, ``optimize_candidates``,
against the JAX package's on the CPU.

One scene's real candidates (a bank's DefaultSearch pairs, aligned) on its
256 x 256 DT3 stack, among them null alignment vectors and templates
outside the canvas; every optimizer (Default, Indulgent, Batch, Dense)
under window generations 2, 3 and 4 (the port's K5, K6 and K1 plain
versions; the JAX package's XLA path is generation-free).  Bars: ``valid``
and the step taken equal, scores within rel 3e-7 (ROADMAP's bar: generation
4 sums a candidate's lines in line order, the JAX package in its own).

A translation is the step multiplier times the rasterized alignment
vector, whose larger component is exactly +-1, so that component is the
multiplier itself.  The port's translation is the IEEE product of the JAX
package's multiplier and its ``rasterize_vector``, bit for bit.  The JAX
package's own translation can be one ulp off that product: inside its jit
XLA:CPU contracts ``m * (inv - 2 c inv)`` into fused operations (6 of 256
candidates here), as it fuses the transforms' ``m * rast + t``
(ROADMAP, "Deliberate divergences").
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openfdcm_tpu as jof
from openfdcm_tpu.core import rasterize as jras
from openfdcm_tpu.matching import optimize as jopt
import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.matching import optimize as topt
from openfdcm_tpu_torch.matching import optimize_kernel as tok
from openfdcm_tpu_torch.matching.match import _bucket, _scene_candidates
from openfdcm_tpu_torch.matching.pipeline import _bank_pairs_for_scene
from tests.torch_cases import three_scene_problem

torch.set_num_threads(1)

OPTIMIZERS = {"default": ot.DefaultOptimize(), "indulgent": ot.IndulgentOptimize(),
              "batch": ot.BatchOptimize(10), "dense": ot.DenseOptimize()}
PARAMS = (6, 5.0, 1.0)


@pytest.fixture(scope="module")
def case():
    """``(inputs, kwargs per mode)``: numpy arrays of one scene's stack and
    candidates, four of them made invalid (two null alignment vectors, two
    templates moved off the canvas)."""
    scenes, templates = three_scene_problem()
    scene = scenes[1]
    fm = jof.build_featuremap(scene, jof.Dt3Params(*PARAMS, jof.Distance.L2),
                              pad_to=256)
    assert fm.dt3.shape[1:] == (256, 256)
    bank = ot.prepare_templates(templates, device="cpu")
    pairs = _bank_pairs_for_scene(ot.DefaultSearch(4, 10), bank, scene)
    lines, mask, align, _, _ = (x.numpy() for x in _scene_candidates(
        bank, pairs, scene, _bucket(pairs.shape[0], 64)))
    lines, align = lines.copy(), align.copy()
    align[0] = 0.0
    align[1] = 1e-7
    lines[2:4] += np.float32(1000.0)
    w, h = fm.feature_size
    inputs = dict(dt3_flat=np.array(fm.dt3).reshape(-1),
                  angles=np.array(fm.angles),
                  scene_tr=np.array(fm.scene_translation), hw=(256, 256),
                  feature_size=np.float32([w, h]), tmpl_lines=lines,
                  line_mask=mask, align_vecs=align)
    kw = {}
    for name, optimizer in OPTIMIZERS.items():
        mode, window = jopt.optimizer_mode(getattr(jof, type(optimizer).__name__)())
        kw[name] = dict(mode=mode, window=max(window, 1),
                        dense_steps=jopt.dense_step_count(
                            getattr(jof, type(optimizer).__name__)(), max(w, h)))
    return inputs, kw


@pytest.fixture(scope="module")
def jax_results(case):
    inputs, kw = case
    args = [jnp.asarray(v) if k != "hw" else v for k, v in inputs.items()]
    return {name: tuple(np.asarray(x) for x in jopt.optimize_candidates(*args, **kw[name]))
            for name in OPTIMIZERS}


@pytest.mark.parametrize("version", [4, 3, 2])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimize_candidates_matches_jax(case, jax_results, name, version,
                                         monkeypatch):
    inputs, kw = case
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    assert tok.window_generation((1, 6, 256, 256)) == version
    args = [torch.as_tensor(v) if k != "hw" else v for k, v in inputs.items()]
    scores, trans, valid = (x.numpy() for x in topt.optimize_candidates(*args, **kw[name]))
    want_s, want_t, want_v = jax_results[name]
    np.testing.assert_array_equal(valid, want_v)
    assert not valid[:4].any() and valid.sum() > 30
    rast = np.asarray(jras.rasterize_vector(jnp.asarray(inputs["align_vecs"])))
    major = np.argmax(np.abs(np.nan_to_num(rast)), axis=1)[:, None]
    steps = (np.take_along_axis(want_t, major, 1)
             * np.take_along_axis(np.nan_to_num(rast), major, 1))
    assert (np.abs(steps[valid]) > 0).any()
    np.testing.assert_array_equal(trans[valid], (steps * rast)[valid])
    np.testing.assert_array_max_ulp(trans[valid], want_t[valid], maxulp=1)
    np.testing.assert_array_equal(trans[~valid], 0.0)
    np.testing.assert_allclose(scores[valid], want_s[valid], rtol=3e-7, atol=0)


def test_optimize_candidates_takes_no_gather_hook(case, monkeypatch):
    """``take_fn`` is the JAX package's gather hook: a clamped gather
    through it gives the ``take_fn=None`` result under generation 4 bit for
    bit (K1's arithmetic in plain ops, in K1's line order), every mode."""
    inputs, kw = case
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", "4")
    args = [torch.as_tensor(v) if k != "hw" else v for k, v in inputs.items()]
    n = inputs["dt3_flat"].size
    for name in sorted(OPTIMIZERS):
        want = topt.optimize_candidates(*args, **kw[name])
        got = topt.optimize_candidates(
            *args, **kw[name], take_fn=lambda f, i: f[i.clamp(0, n - 1)])
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_optimize_is_optimize_candidates(case):
    """The reference-shaped ``optimize`` is ``optimize_candidates`` on the
    feature map: the same scores and translations, ``None`` where invalid."""
    inputs, kw = case
    scenes, _ = three_scene_problem()
    fm = ot.build_featuremap(scenes[1], ot.Dt3Params(*PARAMS, ot.Distance.L2),
                             pad_to=256, device="cpu")
    np.testing.assert_array_equal(fm.dt3.reshape(-1).numpy(), inputs["dt3_flat"])
    lines, mask, align = (inputs[k] for k in ("tmpl_lines", "line_mask", "align_vecs"))
    templates = [ln[m] for ln, m in zip(lines, mask)]
    got = ot.optimize(ot.BatchOptimize(10), templates, align, fm)
    scores, trans, valid = topt.optimize_candidates(
        fm.dt3.reshape(-1), fm.angles, fm.scene_translation, (256, 256),
        inputs["feature_size"], lines, mask, align, **kw["batch"])
    assert [g is None for g in got] == list(~valid.numpy())
    for g, s, t in zip(got, scores.numpy(), trans.numpy()):
        if g is not None:
            assert g[0] == s
            np.testing.assert_array_equal(g[1], t)


def test_optimizer_like():
    assert topt.OptimizerLike == (ot.DefaultOptimize, ot.IndulgentOptimize,
                                  ot.BatchOptimize, ot.DenseOptimize)
    assert all(isinstance(o, topt.OptimizerLike) for o in OPTIMIZERS.values())
