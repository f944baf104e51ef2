"""The port's ``match_many`` slice against the JAX package on the CPU.

Bars: top-k template ids identical; scores within rtol 1e-6 (the JAX
package's ``jnp.power`` is not correctly rounded, the port's ``pow_f32``
is; ROADMAP Queue 3); transforms
within atol 1e-5 (XLA:CPU may fuse the final ``mul * rast + t`` into an
FMA; ROADMAP Queue 3).  The second case feeds the JAX package's own DT3
stack through :mod:`openfdcm_tpu_torch.convert`, so search parity is
checked apart from build parity.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import openfdcm_tpu as of
from openfdcm_tpu.matching import pipeline as jpipe
import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch import convert
from openfdcm_tpu_torch.matching import pipeline as tpipe
from tests.utils import create_lines, make_rotation

torch.set_num_threads(1)

TOP_K = 5


def _problem():
    tmpl = np.asarray(create_lines(10, 80))
    rng = np.random.default_rng(5)
    scenes = []
    for angle, shift in ((np.pi, 3.0), (0.9, 6.0), (-0.5, 11.0)):
        rot = make_rotation(angle)
        placed = (tmpl.reshape(-1, 2) @ rot.T).reshape(-1, 4) + np.float32(shift)
        clutter = rng.uniform(-60, 80, (6, 4)).astype(np.float32)
        scenes.append(np.concatenate([placed, clutter]).astype(np.float32))
    templates = [tmpl, tmpl * np.float32(0.7), tmpl[:6] * np.float32(1.2)]
    return scenes, templates


def _assert_same_topk(got, want):
    assert len(got) == len(want)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            assert g.tmpl_idx == w.tmpl_idx
            assert np.isclose(g.score, w.score, rtol=1e-6, atol=0)
            np.testing.assert_allclose(g.transform, w.transform, rtol=1e-6,
                                       atol=1e-5)


@pytest.fixture(scope="module")
def jax_run():
    scenes, templates = _problem()
    lengths = of.get_template_lengths(templates)
    params = of.Dt3Params(4, 5.0, 2.2, of.Distance.L2)
    bank = of.prepare_templates(templates)
    fms = of.build_featuremap_batch(scenes, params)
    post = (jnp.asarray(np.asarray(lengths, np.float32)), jnp.float32(1.5), TOP_K)
    rows = jpipe._genpairs_batch_dispatch(
        of.DefaultSearch(4, 10), of.BatchOptimize(10), fms, bank, scenes,
        post, scene_chunk=8)()
    matches = of.match_many(scenes, bank, params, of.DefaultSearch(4, 10),
                            of.BatchOptimize(10), penalty=of.ExponentialPenalty(1.5),
                            template_lengths=lengths, top_k=TOP_K)
    return dict(scenes=scenes, templates=templates, lengths=lengths, bank=bank,
                fms=fms, rows=rows, matches=matches)


def test_match_many_matches_jax(jax_run):
    got = ot.match_many(jax_run["scenes"], jax_run["templates"],
                        ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2),
                        ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
                        penalty=ot.ExponentialPenalty(1.5),
                        template_lengths=jax_run["lengths"], top_k=TOP_K,
                        device="cpu")
    _assert_same_topk(got, jax_run["matches"])


def test_search_on_jax_dt3_matches_jax(jax_run):
    fms, bank = jax_run["fms"], jax_run["bank"]
    t_fms = convert.featuremap_batch_from_numpy(
        np.asarray(fms.dt3), np.asarray(fms.angles),
        np.asarray(fms.scene_translations), fms.feature_sizes, fms.params,
        device="cpu")
    t_bank = convert.bank_from_numpy(np.asarray(bank.lines), np.asarray(bank.mask),
                                     bank.host, bank.lengths_np, bank.counts_np,
                                     device="cpu")
    post = (torch.as_tensor(np.asarray(jax_run["lengths"], np.float32)), 1.5, TOP_K)
    rows = tpipe._genpairs_batch_dispatch(
        ot.DefaultSearch(4, 10), ot.BatchOptimize(10), t_fms, t_bank,
        jax_run["scenes"], post, scene_chunk=2)()
    as_matches = lambda per_scene: [[ot.Match(t, s, m) for s, t, m in r]
                                    for r in per_scene]
    _assert_same_topk(as_matches(rows), as_matches(jax_run["rows"]))


def test_match_many_async_equals_sync():
    scenes, templates = _problem()
    args = (scenes[:2], templates[:2], ot.Dt3Params(4, 5.0, 2.0, ot.Distance.L2),
            ot.DefaultSearch(3, 4), ot.BatchOptimize(5))
    kw = dict(penalty=ot.DefaultPenalty(), top_k=4, device="cpu")
    sync = ot.match_many(*args, **kw)
    timer = ot.StageTimer()
    got = ot.match_many_async(*args, timer=timer, **kw)()
    assert set(timer.totals) == {"build_featuremap", "search_topk_devpairs"}
    for a_list, b_list in zip(got, sync):
        assert len(a_list) == len(b_list) > 0
        for a, b in zip(a_list, b_list):
            assert a.tmpl_idx == b.tmpl_idx and a.score == b.score
            np.testing.assert_array_equal(a.transform, b.transform)


def test_unported_options_and_short_lengths_raise():
    """Every optimizer, search strategy and penalty of the JAX package is
    ported: only what the JAX package rejects raises, and short template
    lengths raise on the top-k and the host ranking path alike."""
    scenes, templates = _problem()
    params = ot.Dt3Params(4, 5.0, 2.0, ot.Distance.L2)
    with pytest.raises(TypeError, match="optimizer"):
        ot.match_many(scenes[:1], templates, params, ot.DefaultSearch(3, 4),
                      object(), top_k=3, device="cpu")
    with pytest.raises(TypeError, match="search strategy"):
        ot.match_many(scenes[:1], templates, params, object(),
                      ot.BatchOptimize(5), device="cpu")
    for top_k in (3, None):
        with pytest.raises(IndexError, match="templatelengths"):
            ot.match_many(scenes[:1], templates, params, ot.DefaultSearch(3, 4),
                          ot.BatchOptimize(5), penalty=ot.DefaultPenalty(),
                          template_lengths=[1.0], top_k=top_k, device="cpu")


def test_entry_points_default_to_cuda():
    """Every entry point runs on the card unless the CPU is asked for: with
    no CUDA device it raises instead of running on the CPU."""
    scenes, templates = _problem()
    params = ot.Dt3Params(4, 5.0, 2.0, ot.Distance.L2)
    if torch.cuda.is_available():
        assert ot.prepare_templates(templates).device.type == "cuda"
        assert ot.build_featuremap_batch(scenes[:1], params).dt3.device.type == "cuda"
        return
    bank = ot.prepare_templates(templates, device="cpu")
    calls = [
        lambda: ot.prepare_templates(templates),
        lambda: ot.build_featuremap_batch(scenes[:1], params),
        lambda: ot.match_many(scenes[:1], templates, params, ot.DefaultSearch(3, 4),
                              ot.BatchOptimize(5), top_k=3),
        lambda: ot.match_many_async(scenes[:1], templates, params,
                                    ot.DefaultSearch(3, 4), ot.BatchOptimize(5),
                                    top_k=3),
        lambda: convert.bank_from_numpy(bank.lines.numpy(), bank.mask.numpy(),
                                        bank.host, bank.lengths_np, bank.counts_np),
        lambda: convert.featuremap_batch_from_numpy(
            np.zeros((1, 4, 8, 8), np.float32), np.zeros(4, np.float32),
            np.zeros((1, 2), np.float32), [(8, 8)], params),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
