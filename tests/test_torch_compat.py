"""The reference's Python integration test (``tests/test_compat.py``, itself
a port of the reference's ``tests/python/test_matching.py``) through the
port's drop-in layer ``openfdcm_tpu_torch.compat`` on the CPU, and the
port's sorted matches against the JAX compat's."""
import numpy as np
import pytest
import torch

import openfdcm_tpu.compat as jcompat
import openfdcm_tpu_torch.compat as openfdcm
from tests.test_compat import all_close, apply_transform, create_lines
from tests.torch_cases import assert_same_matches

torch.set_num_threads(1)

DEV = dict(device="cpu")


_FM_CACHE = {}


def _build(scene, params):
    """``build_cpu_featuremap`` on the CPU, once per (scene, distance): the
    reference test builds the same scene several times, and a depth-30 L2
    build takes seconds on the CPU."""
    key = (np.asarray(scene, np.float32).tobytes(), np.shape(scene), params.distance)
    if key not in _FM_CACHE:
        _FM_CACHE[key] = openfdcm.build_cpu_featuremap(scene, params,
                                                       openfdcm.ThreadPool(4), **DEV)
    return _FM_CACHE[key]


@pytest.mark.parametrize("scene_ratio", [1.0, 0.3])
def test_matching(scene_ratio):
    """``tests/test_compat.py::test_matching`` line for line, the feature
    maps built with ``device="cpu"`` (and each distinct one built once)."""
    max_tmpl_lines, max_scene_lines = 4, 10
    threadpool = openfdcm.ThreadPool(4)
    search_strategy = openfdcm.DefaultSearch(max_tmpl_lines, max_scene_lines)
    optimizer_strategy = openfdcm.DefaultOptimize(threadpool)
    matcher = openfdcm.DefaultMatch()
    penalizer = openfdcm.ExponentialPenalty(1.5)
    number_of_lines, line_length = 10, 100
    tmpl = create_lines(number_of_lines, line_length)

    scene_transform = np.array([[-1, 0, line_length], [0, -1, line_length]])
    scene = apply_transform(tmpl, scene_transform)
    # as in the reference, only the first distance sees the rotated scene
    for distance in [openfdcm.distance.L2, openfdcm.distance.L1,
                     openfdcm.distance.L2_SQUARED]:
        params = openfdcm.Dt3CpuParameters(depth=30, dt3Coeff=5.0, padding=2.2,
                                           distance=distance)
        featuremap = _build(scene, params)
        raw = openfdcm.search(matcher, search_strategy, optimizer_strategy,
                              featuremap, [tmpl], scene)
        sorted_matches = openfdcm.sort_matches(raw)
        best = sorted_matches[0].transform
        assert len(sorted_matches) == (min(max_tmpl_lines, number_of_lines)
                                       * min(number_of_lines, max_scene_lines) * 2)
        assert all_close(scene_transform[:2, :2], best[:2, :2])
        assert all_close(scene_transform[:2, 2], best[:2, 2], 1.0 / scene_ratio)

        scene_transform = np.array([[1, 0, 0], [0, 1, 0]])
        scene = apply_transform(tmpl, scene_transform)
        featuremap = _build(scene, params)
        raw = openfdcm.search(matcher, search_strategy, optimizer_strategy,
                              featuremap, [tmpl], scene)
        penalized = openfdcm.penalize(penalizer, raw,
                                      openfdcm.get_template_lengths([tmpl]))
        sorted_matches = openfdcm.sort_matches(penalized)
        assert len(raw) == max_tmpl_lines * max_scene_lines * 2
        assert all_close(scene_transform[:2, :2], sorted_matches[0].transform[:2, :2])
        assert all_close(scene_transform[:2, 2], sorted_matches[0].transform[:2, 2],
                         1.0 / scene_ratio)

        empty_scene = np.zeros((4, 0))
        featuremap = openfdcm.build_cpu_featuremap(empty_scene, params, threadpool, **DEV)
        assert len(openfdcm.search(matcher, search_strategy, optimizer_strategy,
                                   featuremap, [tmpl], empty_scene)) == 0
        featuremap = _build(tmpl, params)
        assert len(openfdcm.search(matcher, search_strategy, optimizer_strategy,
                                   featuremap, [], tmpl)) == 0
        assert len(openfdcm.search(matcher, search_strategy, optimizer_strategy,
                                   featuremap, [np.zeros((4, 0))], tmpl)) == 0


@pytest.mark.parametrize("distance", ["L2", "L1", "L2_SQUARED"])
def test_sorted_matches_equal_jax_compat(distance):
    """Both layers at depth 30 on a rotated scene and on the identity scene,
    with and without the penalty: sorted lists of equal length, ids equal,
    scores rtol 1e-6, transforms atol 1e-5 (the port's parity bar).  Lines
    of 50 px (a 256 px canvas) keep the CPU builds short."""
    tmpl = create_lines(10, 50)
    out = {}
    for name, mod, kw in (("port", openfdcm, DEV), ("jax", jcompat, {})):
        params = mod.Dt3CpuParameters(30, 5.0, 2.2, getattr(mod.distance, distance))
        lists = []
        for mat in (np.array([[-1, 0, 50], [0, -1, 50]]), np.array([[1, 0, 0], [0, 1, 0]])):
            scene = apply_transform(tmpl, mat)
            fm = mod.build_cpu_featuremap(scene, params, **kw)
            raw = mod.search(mod.DefaultMatch(), mod.DefaultSearch(4, 10),
                             mod.BatchOptimize(10), fm, [tmpl, tmpl * 0.5], scene)
            lists.append(mod.sort_matches(raw))
            lists.append(mod.sort_matches(mod.penalize(
                mod.ExponentialPenalty(1.5), raw,
                mod.get_template_lengths([tmpl, tmpl * 0.5]))))
        out[name] = lists
    assert assert_same_matches(out["port"], out["jax"]) == 4 * 160


def test_write_read(tmp_path):
    lines = create_lines(100, 10)
    filepath = str(tmp_path / "test_write_array.lines")
    openfdcm.write(filepath, lines)
    read_lines = openfdcm.read(filepath)
    assert read_lines.shape == lines.shape  # reference 4xN layout
    assert all_close(lines, read_lines)
    # either layer reads the other's file, bit-equal
    jcompat.write(str(tmp_path / "j.lines"), lines)
    np.testing.assert_array_equal(openfdcm.read(str(tmp_path / "j.lines")),
                                  jcompat.read(filepath))
    openfdcm.write(str(tmp_path / "e.lines"), np.zeros((4, 0)))
    assert openfdcm.read(str(tmp_path / "e.lines")).shape == (4, 0)


def test_strategy_wrappers_and_introspection():
    pool = openfdcm.ThreadPool(4)
    assert pool.get_thread_count() == 4
    assert pool.get_tasks_total() == 0
    opt = openfdcm.BatchOptimize(10, pool)
    assert opt.get_batch_size() == 10
    assert opt.get_pool() is pool
    ind = openfdcm.IndulgentOptimize(2)
    assert ind.get_number_of_passthroughs() == 2
    assert openfdcm.DefaultOptimize(num_threads=3).get_pool().get_thread_count() == 3
    s = openfdcm.DefaultSearch(4, 10)
    assert s.get_max_tmpl_lines() == 4 and s.get_max_scene_lines() == 10
    c = openfdcm.ConcentricRangeStrategy(4, 10, (5.0, 5.0), 0.0, 10.0)
    assert c.get_low_radius_boundary() == 0.0
    # erased wrappers accept concretes like the reference's implicit casts
    assert openfdcm.OptimizeStrategy(opt)._concrete is opt
    assert openfdcm.MatchStrategy(openfdcm.DefaultMatch()) is not None
    p = openfdcm.Dt3CpuParameters(30, 5.0, 2.2, openfdcm.distance.L2)
    assert p.depth == 30 and p.dt3_coeff == 5.0
    with pytest.raises(TypeError, match="unexpected"):
        openfdcm.Dt3CpuParameters(bad=1)


def test_featuremap_introspection():
    tmpl = create_lines(5, 20)
    fm = openfdcm.build_cpu_featuremap(tmpl, openfdcm.Dt3CpuParameters(4), **DEV)
    jfm = jcompat.build_cpu_featuremap(tmpl, jcompat.Dt3CpuParameters(4))
    w, h = fm.get_feature_size()
    assert (w, h) == jfm.get_feature_size() and w > 0 and h > 0
    np.testing.assert_array_equal(fm.get_scene_translation(),
                                  jfm.get_scene_translation())
    m, jm = fm.get_dt3_map(), jfm.get_dt3_map()
    assert len(m) == 4 and list(m) == list(jm)
    for angle, img in m.items():
        assert isinstance(img, np.ndarray) and img.shape == (h, w)
        np.testing.assert_array_equal(img, jm[angle])
    assert openfdcm.FeatureMap(fm) is not None
    # search accepts the erased wrapper too
    got = openfdcm.search(openfdcm.DefaultMatch(), openfdcm.DefaultSearch(2, 3),
                          openfdcm.BatchOptimize(5), openfdcm.FeatureMap(fm),
                          [tmpl], tmpl)
    assert len(got) == 2 * 2 * 3


def test_build_without_cuda_raises(monkeypatch):
    """The one call here that creates device state defaults to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        openfdcm.build_cpu_featuremap(create_lines(5, 20))
