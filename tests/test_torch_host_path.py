"""The rest of the port's search against the JAX package on the CPU:
``match_many`` without ``top_k`` (the host ranking path), with a
``ConcentricRangeStrategy``, with ``DenseOptimize``, with a subclassed
searcher and with a user penalty, and ``search_batch``.

Bars: host-path match lists of the same length and order, ids equal,
scores rtol 1e-6, transforms atol 1e-5; dense scores rel <= 3e-7 before the
penalty (K1 sums a candidate's lines in line order, XLA in its own order)
with top-k ids identical; within the port, the host ranking path's sorted
head equals the device top-k exactly.
"""
import numpy as np
import pytest
import torch

import openfdcm_tpu as of
import openfdcm_tpu_torch as ot
from tests.torch_cases import assert_same_matches, three_scene_problem

torch.set_num_threads(1)

TOP_K = 5
PARAMS = (4, 5.0, 2.2)


def _annulus(pkg, scenes, share=0.5):
    """A ConcentricRangeStrategy around the scenes' common center whose
    outer radius keeps about ``share`` of the lines."""
    pts = np.concatenate(scenes).reshape(-1, 2)
    center = pts.mean(axis=0)
    mids = np.concatenate([(s[:, :2] + s[:, 2:]) / 2 for s in scenes])
    hi = float(np.quantile(np.linalg.norm(mids - center, axis=1), share))
    return pkg.ConcentricRangeStrategy(4, 10, tuple(float(c) for c in center),
                                       2.0, hi)


def _subclass(pkg):
    """A DefaultSearch subclass of ``pkg`` (the JAX package routes it to
    its host ranking path)."""
    return type("MySearch", (pkg.DefaultSearch,), {})(4, 10)


class UserPenalty:
    """A penalty of neither built-in type: ``score / max(len, 1)``."""

    def apply(self, score, length):
        return np.asarray(score, np.float32) / np.maximum(
            np.asarray(length, np.float32), np.float32(1.0))


# name -> (searcher, optimizer, penalty, top_k), each given the package
CASES = {
    "host": (lambda p, s: p.DefaultSearch(4, 10), lambda p: p.BatchOptimize(10),
             lambda p: None, None),
    "host-penalized": (lambda p, s: p.DefaultSearch(4, 10),
                       lambda p: p.DefaultOptimize(),
                       lambda p: p.ExponentialPenalty(1.5), None),
    "concentric-topk": (_annulus, lambda p: p.BatchOptimize(10),
                        lambda p: p.ExponentialPenalty(1.5), TOP_K),
    "concentric-host": (_annulus, lambda p: p.BatchOptimize(10),
                        lambda p: p.DefaultPenalty(), None),
    "subclass-topk": (lambda p, s: _subclass(p), lambda p: p.BatchOptimize(10),
                      lambda p: p.ExponentialPenalty(1.5), TOP_K),
    "user-penalty-topk": (lambda p, s: p.DefaultSearch(4, 10),
                          lambda p: p.IndulgentOptimize(),
                          lambda p: UserPenalty(), TOP_K),
    "dense-topk": (lambda p, s: p.DefaultSearch(4, 10),
                   lambda p: p.DenseOptimize(), lambda p: None, TOP_K),
    "dense-host": (lambda p, s: p.DefaultSearch(4, 10),
                   lambda p: p.DenseOptimize(max_steps=100),
                   lambda p: None, None),
}


def _run(pkg, name, scenes, templates, lengths):
    searcher, optimizer, penalty, top_k = CASES[name]
    kw = dict(device="cpu") if pkg is ot else {}
    return pkg.match_many(scenes, templates,
                          pkg.Dt3Params(*PARAMS, pkg.Distance.L2),
                          searcher(pkg, scenes), optimizer(pkg),
                          penalty=penalty(pkg), template_lengths=lengths,
                          top_k=top_k, **kw)


@pytest.fixture(scope="module")
def problem():
    scenes, templates = three_scene_problem()
    return scenes, templates, of.get_template_lengths(templates)


@pytest.fixture(scope="module")
def jax_results(problem):
    return {name: _run(of, name, *problem) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_match_many_matches_jax(name, problem, jax_results):
    got = _run(ot, name, *problem)
    want = jax_results[name]
    if name.startswith("dense"):
        # scores rel <= 3e-7 (line-order sums); ids and transforms of the
        # top-k identical where the scores are
        for g_list, w_list in zip(got, want):
            assert len(g_list) == len(w_list) > 0
            for g, w in zip(g_list, w_list):
                assert g.tmpl_idx == w.tmpl_idx
                assert abs(g.score - w.score) <= 3e-7 * abs(w.score)
                np.testing.assert_allclose(g.transform, w.transform, atol=1e-5)
        return
    assert assert_same_matches(got, want) > 0


def test_concentric_annulus_keeps_part_of_the_scene(problem, jax_results):
    scenes = problem[0]
    strat = _annulus(ot, scenes)
    kept = sum(len(ot.matching.search.filter_in_range(
        s, strat.center_position, strat.low_boundary, strat.high_boundary))
        for s in scenes)
    total = sum(len(s) for s in scenes)
    assert 0.2 * total < kept < 0.8 * total
    host = {len(m) for m in _run(ot, "concentric-host", *problem)}
    full = {len(m) for m in _run(ot, "host", *problem)}
    assert max(host) < max(full)


def test_covering_annulus_equals_default_search(problem):
    scenes, templates, lengths = problem
    params = ot.Dt3Params(*PARAMS, ot.Distance.L2)
    args = (scenes, templates, params)
    kw = dict(penalty=ot.ExponentialPenalty(1.5), template_lengths=lengths,
              top_k=TOP_K, device="cpu")
    every = ot.ConcentricRangeStrategy(4, 10, (0.0, 0.0), 0.0, 1e9)
    got = ot.match_many(*args, every, ot.BatchOptimize(10), **kw)
    want = ot.match_many(*args, ot.DefaultSearch(4, 10), ot.BatchOptimize(10), **kw)
    assert_same_matches(got, want, exact=True)


@pytest.mark.parametrize("optimizer", ["BatchOptimize", "DenseOptimize"])
def test_host_ranking_head_equals_device_topk(problem, optimizer):
    """The host ranking path sorted and cut to k equals the device top-k:
    the same candidates, ``pow_f32`` on both sides, ties to the lowest
    candidate index."""
    scenes, templates, lengths = problem
    params = ot.Dt3Params(*PARAMS, ot.Distance.L2)
    opt = ot.BatchOptimize(10) if optimizer == "BatchOptimize" else ot.DenseOptimize()
    kw = dict(penalty=ot.ExponentialPenalty(1.5), template_lengths=lengths,
              device="cpu")
    full = ot.match_many(scenes, templates, params, ot.DefaultSearch(4, 10),
                         opt, **kw)
    top = ot.match_many(scenes, templates, params, ot.DefaultSearch(4, 10),
                        opt, top_k=TOP_K, **kw)
    head = [ot.sort_matches(m)[:TOP_K] for m in full]
    assert_same_matches(head, top, exact=True)
    # a user penalty computing the same function through the host path, and
    # a subclassed searcher through host pairs and the device top-k
    class SamePenalty:
        def apply(self, score, length):
            return ot.ExponentialPenalty(1.5).apply(score, length)
    user = ot.match_many(scenes, templates, params, ot.DefaultSearch(4, 10),
                         opt, top_k=TOP_K, **dict(kw, penalty=SamePenalty()))
    sub = ot.match_many(scenes, templates, params, _subclass(ot), opt,
                        top_k=TOP_K, **kw)
    assert_same_matches(user, top, exact=True)
    assert_same_matches(sub, top, exact=True)


def test_dense_not_worse_than_batch(problem):
    """Per scene, the dense top-1 is <= the BatchOptimize top-1 exactly:
    both read the same K1 probes and the dense range holds every step a
    greedy walk visits."""
    scenes, templates, lengths = problem
    params = ot.Dt3Params(*PARAMS, ot.Distance.L2)
    kw = dict(penalty=ot.ExponentialPenalty(1.5), template_lengths=lengths,
              top_k=1, device="cpu")
    dense = ot.match_many(scenes, templates, params, ot.DefaultSearch(4, 10),
                          ot.DenseOptimize(), **kw)
    batch = ot.match_many(scenes, templates, params, ot.DefaultSearch(4, 10),
                          ot.BatchOptimize(10), **kw)
    for d, b in zip(dense, batch):
        assert d[0].score <= b[0].score


def test_search_batch_matches_jax(problem):
    scenes, templates, _ = problem
    jfms = of.build_featuremap_batch(scenes, of.Dt3Params(*PARAMS, of.Distance.L2))
    tfms = ot.build_featuremap_batch(scenes, ot.Dt3Params(*PARAMS, ot.Distance.L2),
                                     device="cpu")
    want = of.search_batch(of.DefaultMatch(), of.DefaultSearch(4, 10),
                           of.DefaultOptimize(), jfms, templates, scenes)
    got = ot.search_batch(ot.DefaultMatch(), ot.DefaultSearch(4, 10),
                          ot.DefaultOptimize(), tfms, templates, scenes)
    assert assert_same_matches(got, want) > 0
    bank = ot.prepare_templates(templates, device="meta")
    with pytest.raises(ValueError, match="template bank"):
        ot.search_batch(ot.DefaultMatch(), ot.DefaultSearch(4, 10),
                        ot.DefaultOptimize(), tfms, bank, scenes)
