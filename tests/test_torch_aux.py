"""The port's auxiliary modules: profiling stages and traces, the error
types, and ``viz`` images equal to the JAX package's."""
import os

import numpy as np
import torch

import openfdcm_tpu as jof
import openfdcm_tpu_torch as ot
from openfdcm_tpu import viz as jviz
from openfdcm_tpu_torch import viz
from tests.utils import apply_transform, create_lines, make_rotation


def test_profiling_stages():
    ot.profiling.reset()
    with ot.profiling.stage("unit-test-stage"):
        _ = np.arange(10).sum()
    with ot.profiling.stage("unit-test-stage", sync=True):
        _ = torch.ones(3).sum()
    rep = ot.profiling.report()
    total, count = rep["unit-test-stage"]
    assert count == 2 and total >= 0.0
    ot.profiling.reset()
    assert ot.profiling.report() == {}


def test_profiling_trace(tmp_path):
    """A trace records the stage annotations and is written as a Chrome
    trace into the directory."""
    ot.profiling.start_trace(str(tmp_path / "trace"))
    with ot.profiling.stage("traced-stage"):
        torch.ones(64).cumsum(0)
    path = ot.profiling.stop_trace()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        assert "traced-stage" in f.read()


def test_exports_cover_the_jax_package():
    relay = {"ensure_backend", "enable_compilation_cache"}
    assert not (set(jof.__all__) - relay) - set(ot.__all__)
    assert all(hasattr(ot, n) for n in ot.__all__)


def test_error_types():
    assert issubclass(ot.PointOutOfBound, ot.OpenFDCMError)
    assert issubclass(ot.ImgProcError, ot.OpenFDCMError)
    assert ot.distance is ot.Distance and ot.version_info == jof.version_info


def test_draw_matches_equals_jax():
    templates = [np.asarray(create_lines(6, 40.0)), np.asarray(create_lines(4, 25.0))]
    mat = np.concatenate([make_rotation(0.3), np.full((2, 1), 50.0, np.float32)], 1)
    scene = apply_transform(templates[0], mat)
    shifted = mat + np.asarray([[0, 0, 15.0], [0, 0, -9.0]], np.float32)
    matches = [ot.Match(0, 0.1, shifted), ot.Match(1, 0.2, mat * 0.5)]
    for kw in (dict(top=2), dict(top=1, shape=(140, 120))):
        got = viz.draw_matches(scene, matches, templates, **kw)
        want = jviz.draw_matches(scene, matches, templates, **kw)
        assert got.dtype == np.uint8 and (got == 255).any() and (got == 128).any()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(viz.transformed_template(templates[1], mat),
                                  jviz.transformed_template(templates[1], mat))
    np.testing.assert_array_equal(viz.draw_lines_image(np.zeros((0, 4))),
                                  jviz.draw_lines_image(np.zeros((0, 4))))
