"""The port's host pair tables against the JAX package's numpy path:
``establish_search_strategy``, ``bank_pairs``, ``filter_in_range``,
``get_centered_range`` and the annulus of ``scene_length_mask``, bit-equal;
plus the reference's search-strategy cases
(``tests/matching/src/searchstrategy.test.cpp``, as ``test_search.py`` runs
them) and the annulus through ``device_pairs``.
"""
import numpy as np
import pytest
import torch

from openfdcm_tpu.matching import search as jsearch
import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.matching import search as tsearch

torch.set_num_threads(1)


def _combos_set(arr):
    return {(int(a), int(b)) for a, b in arr}


def test_reference_cases():
    scene = np.array([[0, 0, 1, 0], [0, 0, 2, 0], [0, 0, 3, 0],
                      [0, 0, 6, 0], [0, 0, 5, 0]], np.float32)
    tmpl = np.array([[0, 0, 2, 0], [0, 0, 3, 0], [0, 0, 1, 0],
                     [0, 0, 8, 0]], np.float32)
    combos = ot.establish_search_strategy(ot.DefaultSearch(2, 2), tmpl, scene)
    assert _combos_set(combos) <= {(3, 3), (3, 4), (1, 2), (1, 4)} and len(combos) == 4
    assert tsearch.get_centered_range(30, 60, 60) == (0, 60)
    assert tsearch.get_centered_range(0, 6, 2) == (0, 2)
    assert tsearch.get_centered_range(5, 6, 2) == (4, 6)
    lines = np.array([[0, 0, 5, 5], [2, 2, 4, 4], [0, 0, 5, 0], [0, 0, 0, 5],
                      [0, 0, 2, 2], [3, 3, 4, 4], [4, 0, 5, 5]], np.float32)
    assert list(tsearch.filter_in_range(lines, (2.5, 2.5), 0.0, 2.0)) == [0, 1, 5]

    strat = ot.ConcentricRangeStrategy(2, 2, (0, 0), 5, 15)
    assert (strat.get_center_position(), strat.get_low_radius_boundary(),
            strat.get_high_radius_boundary(), strat.get_max_tmpl_lines(),
            strat.get_max_scene_lines()) == ((0, 0), 5, 15, 2, 2)
    empty = np.zeros((0, 4), np.float32)
    assert len(ot.establish_search_strategy(strat, tmpl, empty)) == 0
    assert len(ot.establish_search_strategy(strat, empty, tmpl)) == 0
    scene = np.array([[0, 0, 1, 0], [0, 0, 13, 0], [0, 0, 30, 0],
                      [0, 0, 20, 0], [0, 0, 5, 0]], np.float32)
    combos = ot.establish_search_strategy(strat, tmpl, scene)
    assert _combos_set(combos) <= {(3, 1), (3, 3), (1, 1), (1, 3)} and len(combos) == 4
    scene = np.array([[0, 0, 2, 0], [2, 0, 4, 0], [4, 0, 7, 0], [7, 0, 15, 0]],
                     np.float32)
    for center, lo, hi, expect in (((4, 0), 0, 2, (0, 1)), ((4, 0), 3, 15, (0, 3)),
                                   ((4, 0), 3, np.inf, (0, 3)), ((4, 0), 2, 4, (0, 0))):
        combos = ot.establish_search_strategy(
            ot.ConcentricRangeStrategy(1, 1, center, lo, hi), tmpl[:1], scene)
        assert tuple(int(v) for v in combos[0]) == expect
    with pytest.raises(TypeError, match="search strategy"):
        ot.establish_search_strategy(object(), tmpl, scene)


def _random_case(seed):
    rng = np.random.default_rng(seed)
    # quantized coordinates so lengths tie and the tie rules matter
    scene = rng.integers(0, 40, (37, 4)).astype(np.float32)
    templates = [rng.integers(0, 30, (int(rng.integers(1, 9)), 4)).astype(np.float32)
                 for _ in range(5)]
    center = tuple(float(c) for c in rng.uniform(10, 30, 2))
    return scene, templates, center


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_pairs_bit_equal(seed):
    scene, templates, center = _random_case(seed)
    bank = ot.prepare_templates(templates, device="cpu")
    for t_args in ((3, 4), (9, 2), (2, 40)):
        for jstrat, tstrat in (
                (jsearch.DefaultSearch(*t_args), ot.DefaultSearch(*t_args)),
                (jsearch.ConcentricRangeStrategy(*t_args, center, 3.0, 14.0),
                 ot.ConcentricRangeStrategy(*t_args, center, 3.0, 14.0))):
            # the JAX package's numpy path (its native extension reproduces it)
            want = np.concatenate([np.concatenate([np.full((len(p), 1), i), p], 1)
                                   for i, t in enumerate(templates)
                                   for p in [jsearch._pair_by_length(
                                       jsearch._lengths(t),
                                       *_filtered(jstrat, scene), *t_args)]])
            got = tsearch.bank_pairs(tstrat, bank.lengths_np, bank.counts_np, scene)
            np.testing.assert_array_equal(got, want)
            for i, t in enumerate(templates):
                np.testing.assert_array_equal(
                    ot.establish_search_strategy(tstrat, t, scene),
                    want[want[:, 0] == i, 1:])
    np.testing.assert_array_equal(
        tsearch.filter_in_range(scene, center, 3.0, 14.0),
        jsearch.filter_in_range(scene, center, 3.0, 14.0))


def _filtered(strat, scene):
    """The scene lengths and ids a strategy keeps (JAX numpy path)."""
    if isinstance(strat, jsearch.ConcentricRangeStrategy):
        ids = np.asarray(jsearch.filter_in_range(
            scene, strat.center_position, strat.low_boundary,
            strat.high_boundary), np.int64)
    else:
        ids = np.arange(scene.shape[0])
    return jsearch._lengths(scene[ids]), ids


@pytest.mark.parametrize("seed", [0, 1])
def test_annulus_mask_and_device_pairs_bit_equal(seed):
    """The annulus folded into scene validity (with the f32 epsilon rule at
    the inner radius) equals the JAX package's, and ``device_pairs`` on it
    reproduces the host ``bank_pairs`` of a ConcentricRangeStrategy."""
    scene, templates, center = _random_case(seed)
    mids = (scene[:, :2] + scene[:, 2:]) / 2
    lo = float(np.sqrt(((mids[0] - np.float32(center)) ** 2).sum(dtype=np.float32)))
    hi = lo + 15.0
    # line 0 sits exactly on the inner radius, where the f32 epsilon
    # rule decides it
    annulus = (*center, lo, hi)
    want = jsearch.scene_length_mask(scene, 64, annulus)
    got = tsearch.scene_length_mask(scene, 64, annulus)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < got[1].sum() < scene.shape[0]

    bank = ot.prepare_templates(templates, device="cpu")
    ms, mt = 4, 3
    ord_t, k_t = tsearch.bank_line_table(bank.lengths_np, bank.counts_np, mt)
    lens = np.where(np.arange(bank.lmax)[None] < bank.counts_np[:, None],
                    bank.lengths_np, -np.inf)
    top_vals = np.take_along_axis(lens, ord_t.astype(np.int64), 1).astype(np.float32)
    rank_ok = np.arange(mt)[None] < k_t[:, None]
    sl, ok = tsearch.device_pairs(torch.as_tensor(got[0])[None],
                                  torch.as_tensor(got[1])[None],
                                  torch.as_tensor(top_vals),
                                  torch.as_tensor(rank_ok), ms)
    grid = np.stack(np.broadcast_arrays(np.arange(len(templates))[:, None, None],
                                        ord_t[:, :, None], sl[0].numpy()), -1)
    host = tsearch.bank_pairs(ot.ConcentricRangeStrategy(mt, ms, center, lo, hi),
                              bank.lengths_np, bank.counts_np, scene)
    np.testing.assert_array_equal(grid[ok[0].numpy()], host)
