"""The port's single-scene API against the JAX package on the CPU:
``build_featuremap`` (``pad_to=128`` and ``None``), ``Dt3FeaturemapBatch.
featuremap``, ``search`` under window generations 2, 3 and 4, ``optimize``
(the reference optimizer suites, every optimizer), ``penalize`` and
``sort_matches``, ``evaluate`` (and the numpy oracle), ``minmax_translation``
and ``save_featuremap`` / ``load_featuremap`` across the two packages.

Bars: DT3 stacks bit-equal; match lists of the same length and order, ids
equal, scores rtol 1e-6 (rel 3e-7 for the window sums), transforms atol
1e-5; evaluate rel 3e-7 (the port sums lines in line order).
"""
import jax
import numpy as np
import pytest
import torch

import openfdcm_tpu as of
import openfdcm_tpu_torch as ot
from openfdcm_tpu.matching import featuremap as jfm
from openfdcm_tpu.matching.search import establish_search_strategy
import openfdcm_tpu.core.geometry as jgeo
from tests import oracle
from tests.torch_cases import assert_same_matches, three_scene_problem
from tests.utils import apply_transform, create_lines

torch.set_num_threads(1)

PARAMS = (4, 5.0, 2.2)


@pytest.fixture(scope="module")
def scene0():
    scenes, templates = three_scene_problem()
    return scenes[0], templates


@pytest.fixture(scope="module")
def builds(scene0):
    scene, _ = scene0
    out = {}
    for pad_to in (128, None):
        out[pad_to] = (
            of.build_featuremap(scene, of.Dt3Params(*PARAMS, of.Distance.L2),
                                pad_to=pad_to),
            ot.build_featuremap(scene, ot.Dt3Params(*PARAMS, ot.Distance.L2),
                                pad_to=pad_to, device="cpu"))
    return out


@pytest.mark.parametrize("pad_to", [128, None])
def test_build_featuremap_bit_equal(builds, pad_to):
    jf, tf = builds[pad_to]
    assert tf.dt3.shape == ((4, 384, 384) if pad_to else (4, 350, 350))
    np.testing.assert_array_equal(tf.dt3.numpy(), np.asarray(jf.dt3))
    np.testing.assert_array_equal(tf.angles.numpy(), np.asarray(jf.angles))
    np.testing.assert_array_equal(tf.scene_translation.numpy(),
                                  np.asarray(jf.scene_translation))
    assert tf.feature_size == jf.feature_size and tf.depth == jf.depth
    assert tf.get_feature_size() == tf.feature_size
    assert tf.get_scene_translation() is tf.scene_translation


def test_batch_featuremap_view_equals_single_build(builds):
    scenes, _ = three_scene_problem()
    fms = ot.build_featuremap_batch(scenes, ot.Dt3Params(*PARAMS, ot.Distance.L2),
                                    device="cpu")
    one = fms.featuremap(0)
    single = builds[128][1]
    np.testing.assert_array_equal(one.dt3.numpy(), single.dt3.numpy())
    assert one.feature_size == single.feature_size


def test_empty_scene_and_device_argument():
    empty = ot.build_featuremap(np.zeros((0, 4), np.float32), device="cpu")
    assert empty.feature_size == (0, 0) and empty.dt3.shape == (0, 0, 0)
    assert ot.search(ot.DefaultMatch(), ot.DefaultSearch(4, 10),
                     ot.BatchOptimize(10), empty, [create_lines(4, 20)],
                     np.zeros((0, 4), np.float32)) == []
    assert ot.optimize(ot.DefaultOptimize(), [create_lines(2, 5)],
                       [np.ones(2)], empty) == [None]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ot.build_featuremap(create_lines(4, 20))


@pytest.mark.parametrize("pad_to", [128, None])
def test_search_matches_jax_at_every_generation(builds, scene0, pad_to,
                                                monkeypatch):
    """Unsorted lists in emplace order; on the 350-px canvas generations 2
    and 3 run generation 4's windows (the canvas gate), on the 384-px
    canvas their own kernels' plain versions."""
    scene, templates = scene0
    jf, tf = builds[pad_to]
    want = of.search(of.DefaultMatch(), of.DefaultSearch(4, 10),
                     of.BatchOptimize(10), jf, templates, scene)
    for version in ("4", "2", "3"):
        monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", version)
        got = ot.search(ot.DefaultMatch(), ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), tf, templates, scene)
        assert len(got) == len(want) > 100
        for g, w in zip(got, want):
            assert g.tmpl_idx == w.tmpl_idx
            assert abs(g.score - w.score) <= 3e-7 * abs(w.score)
            np.testing.assert_allclose(g.transform, w.transform, atol=1e-5)


def test_search_equals_match_many(builds, scene0):
    """``search`` -> ``penalize`` -> ``sort_matches`` gives ``match_many``'s
    top-k exactly."""
    scene, templates = scene0
    _, tf = builds[128]
    lengths = ot.get_template_lengths(templates)
    matches = ot.search(ot.DefaultMatch(), ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), tf, templates, scene)
    ranked = ot.sort_matches(ot.penalize(ot.ExponentialPenalty(1.5), matches,
                                         lengths))[:5]
    top = ot.match_many([scene], templates, ot.Dt3Params(*PARAMS, ot.Distance.L2),
                        ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
                        penalty=ot.ExponentialPenalty(1.5),
                        template_lengths=lengths, top_k=5, device="cpu")[0]
    assert_same_matches([ranked], [top], exact=True)


def test_penalize_matches_jax(builds, scene0):
    scene, templates = scene0
    jf, tf = builds[128]
    lengths = of.get_template_lengths(templates)
    jm = of.search(of.DefaultMatch(), of.DefaultSearch(4, 10),
                   of.DefaultOptimize(), jf, templates, scene)
    tm = ot.search(ot.DefaultMatch(), ot.DefaultSearch(4, 10),
                   ot.DefaultOptimize(), tf, templates, scene)
    for jp, tp in ((of.DefaultPenalty(), ot.DefaultPenalty()),
                   (of.ExponentialPenalty(1.5), ot.ExponentialPenalty(1.5))):
        want = of.sort_matches(of.penalize(jp, jm, lengths))
        got = ot.sort_matches(ot.penalize(tp, tm, lengths))
        assert_same_matches([got], [want], ordered=False)
        assert_same_matches([got[:5]], [want[:5]])
    with pytest.raises(IndexError, match="templatelengths"):
        ot.penalize(ot.DefaultPenalty(), tm, lengths[:1])


# the reference optimizer suites (optimizeStrategies/*.test.cpp), as the
# JAX package's tests/test_optimize.py runs them
OPT_CASES = {
    "perfect": ([[10, 0, 10, 10], [0, 0, 0, 0]], [[15, 0, 15, 10], [5, 0, 5, 0]],
                [1.0, 0.0], (4, 1.0, 1.0), [[1, 0, 5], [0, 1, 0]]),
    "larger": ([[0, 0, 5, 0]], [[3, 0, 6, 0], [0, 10, 7, 10]], [1.0, 0.0],
               (4, 1.0, 1.0), None),
    "out_of_bounds": ([[0, 0, 10, 10]], [[0, 0, 1, 0]], [1.0, 0.0],
                      (4, 1.0, 1.0), None),
    "null_align": ([[0, 0, 1, 0]], [[0, 0, 3, 0]], [0.0, 0.0], (4, 1.0, 2.0),
                   None),
}
OPTIMIZERS = ("DefaultOptimize", "BatchOptimize", "IndulgentOptimize",
              "DenseOptimize")


def _optimizer(pkg, name):
    return {"DefaultOptimize": pkg.DefaultOptimize(),
            "BatchOptimize": pkg.BatchOptimize(10),
            "IndulgentOptimize": pkg.IndulgentOptimize(1),
            "DenseOptimize": pkg.DenseOptimize()}[name]


@pytest.fixture(scope="module")
def optimize_jax():
    out = {}
    for case, (tmpl, scene, align, p, tr) in OPT_CASES.items():
        tmpl = np.asarray(tmpl, np.float32)
        if tr is not None:
            tmpl = apply_transform(tmpl, np.asarray(tr, np.float32))
        fm = of.build_featuremap(np.asarray(scene, np.float32), of.Dt3Params(*p))
        for name in OPTIMIZERS:
            out[case, name] = of.optimize(_optimizer(of, name), [tmpl],
                                          [np.asarray(align)], fm)[0]
    return out


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimize_reference_cases(case, optimize_jax):
    tmpl, scene, align, p, tr = OPT_CASES[case]
    tmpl = np.asarray(tmpl, np.float32)
    if tr is not None:
        tmpl = apply_transform(tmpl, np.asarray(tr, np.float32))
    fm = ot.build_featuremap(np.asarray(scene, np.float32), ot.Dt3Params(*p),
                             device="cpu")
    for name in OPTIMIZERS:
        got = ot.optimize(_optimizer(ot, name), [tmpl], [np.asarray(align)], fm)[0]
        want = optimize_jax[case, name]
        assert (got is None) == (want is None), (case, name)
        if want is not None:
            assert got[0] == pytest.approx(want[0], rel=3e-7, abs=0)
            np.testing.assert_array_equal(got[1], want[1])
    if case == "perfect":
        assert got == (0.0, pytest.approx([0.0, 0.0]))


def test_optimize_dense_not_worse_than_greedy():
    rng = np.random.default_rng(7)
    scene = rng.uniform(0, 30, size=(6, 4)).astype(np.float32)
    fm = ot.build_featuremap(scene, ot.Dt3Params(8, 1.0, 1.5), device="cpu")
    tmpl = rng.uniform(5, 20, size=(3, 4)).astype(np.float32)
    aligns = [np.array(a) for a in ([1.0, 0.0], [0.0, 1.0], [0.7, 0.7])]
    greedy = ot.optimize(ot.DefaultOptimize(), [tmpl] * 3, aligns, fm)
    dense = ot.optimize(ot.DenseOptimize(), [tmpl] * 3, aligns, fm)
    for g, d in zip(greedy, dense):
        assert (g is None) == (d is None)
        if g is not None:
            assert d[0] <= g[0]


def test_evaluate_matches_jax_and_oracle(builds, scene0):
    _, templates = scene0
    jf, tf = builds[None]
    trs = [[np.asarray([2.0, 1.0]), np.asarray([-3.0, 0.5]), np.zeros(2)],
           [np.asarray([400.0, -900.0])],           # probes clamped to the stack
           [np.asarray([1.5, 1.5])]]
    # zip semantics: the third translation list has no template
    want = of.evaluate(jf, templates[:2], trs)
    got = ot.evaluate(tf, templates[:2], trs)
    assert [len(g) for g in got] == [len(w) for w in want] == [3, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=3e-7, atol=0)
    w, h = tf.feature_size
    orc = oracle.evaluate(tf.dt3.numpy()[:, :h, :w], tf.angles.numpy(),
                          tf.scene_translation.numpy(), templates[0], trs[0])
    np.testing.assert_allclose(got[0], orc, rtol=1e-6)
    assert ot.evaluate(tf, [], []) == []


def test_minmax_translation_matches_jax(builds):
    jf, tf = builds[128]
    rng = np.random.default_rng(4)
    tmpl = rng.uniform(-40, 40, (16, 3, 4)).astype(np.float32)
    align = rng.normal(size=(16, 2)).astype(np.float32)
    align[0] = 0.0
    tmpl[1] += 1000.0                                  # leaves the image
    jn, jp = jfm.minmax_translation(jf, jax.numpy.asarray(tmpl),
                                    jax.numpy.asarray(align))
    tn, tp = ot.minmax_translation(tf, torch.as_tensor(tmpl), torch.as_tensor(align))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert np.isinf(float(tn[0])) and np.isnan(float(tn[1]))


def test_save_load_across_packages(builds, tmp_path):
    jf, tf = builds[None]
    ot.save_featuremap(str(tmp_path / "port.npz"), tf)
    of.save_featuremap(str(tmp_path / "jax.npz"), jf)
    back = ot.load_featuremap(str(tmp_path / "port.npz"), device="cpu")
    from_jax = ot.load_featuremap(str(tmp_path / "jax.npz"), device="cpu")
    by_jax = of.load_featuremap(str(tmp_path / "port.npz"))
    for fm in (back, from_jax):
        np.testing.assert_array_equal(fm.dt3.numpy(), tf.dt3.numpy())
        np.testing.assert_array_equal(fm.scene_translation.numpy(),
                                      tf.scene_translation.numpy())
        assert fm.feature_size == tf.feature_size and fm.params == tf.params
    np.testing.assert_array_equal(np.asarray(by_jax.dt3), tf.dt3.numpy())
    assert by_jax.feature_size == tf.feature_size


@pytest.mark.parametrize("optimizer", ["DefaultOptimize", "BatchOptimize"])
def test_search_walks_match_reference_oracle(optimizer):
    """Candidate by candidate, ``search``'s walks against the f32-faithful
    numpy oracle of the reference (``tests/oracle.py``), as the JAX
    package's ``test_oracle_parity.py`` runs it."""
    tmpl = np.asarray(create_lines(10, 60))
    scene = apply_transform(tmpl, np.array([[-1, 0, 60], [0, -1, 60]], np.float32))
    fm = ot.build_featuremap(scene, ot.Dt3Params(8, 5.0, 2.2, ot.Distance.L2),
                             device="cpu")
    w, h = fm.feature_size
    dt3 = fm.dt3.numpy()[:, :h, :w]
    opt = (ot.DefaultOptimize() if optimizer == "DefaultOptimize"
           else ot.BatchOptimize(10))
    orc = (oracle.default_optimize if optimizer == "DefaultOptimize"
           else lambda *a: oracle.batch_optimize(*a, 10))
    matches = ot.search(ot.DefaultMatch(), ot.DefaultSearch(4, 10), opt, fm,
                        [tmpl], scene)
    ta, sa = jgeo.as_lines_np(tmpl), jgeo.as_lines_np(scene)
    checked = 0
    for tl, sl in establish_search_strategy(of.DefaultSearch(4, 10), ta, sa):
        transforms = np.asarray(jgeo.align(jax.numpy.asarray(ta[tl]),
                                           jax.numpy.asarray(sa[sl])))
        av = np.asarray(jgeo.normalize(jax.numpy.asarray(sa[sl])))
        for pol in range(2):
            aligned = np.asarray(jgeo.transform(jax.numpy.asarray(ta),
                                                jax.numpy.asarray(transforms[pol])))
            r = orc(dt3, fm.angles.numpy(), fm.scene_translation.numpy(),
                    (float(w), float(h)), aligned, av)
            if r is not None:
                assert np.isclose(r[0], matches[checked].score, rtol=1e-6,
                                  atol=1e-3)
                checked += 1
    assert checked == len(matches) > 0
