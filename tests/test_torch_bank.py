"""The port's template-bank sharding on meshes of ``cpu`` entries: scores
bit-equal to the unsharded ``match_many(..., top_k=k)`` (equal scores
compared after a stable sort by (score, template id)), and within the
parity bars of the JAX package's bank-sharded call on its eight virtual
devices.  Mirrors ``tests/test_bank.py``."""
import numpy as np
import pytest
import torch

import openfdcm_tpu as jof
import openfdcm_tpu_torch as ot
from openfdcm_tpu.parallel import make_mesh as jax_make_mesh
from openfdcm_tpu.parallel.bank import (
    match_many_bank_sharded as jax_bank_sharded,
    prepare_bank_shards as jax_prepare_bank_shards)
from openfdcm_tpu_torch.parallel import (make_mesh, match_many_bank_sharded,
                                         prepare_bank_shards)
from tests.test_bank import _bank_and_scenes

torch.set_num_threads(1)

CPU = torch.device("cpu")
PARAMS = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)


def _mesh(shape, axes):
    return make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


def _sorted(matches):
    return sorted(matches, key=lambda m: (m.score, m.tmpl_idx))


def _assert_same(got, want, *, exact):
    """Per scene the same matches after a stable sort by (score, template
    id): scores and transforms equal (``exact``), else the JAX bars
    (penalized rtol 1e-6, transforms atol 1e-5)."""
    assert len(got) == len(want)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list)
        for g, w in zip(_sorted(g_list), _sorted(w_list)):
            assert g.tmpl_idx == w.tmpl_idx
            if exact:
                assert g.score == w.score
                np.testing.assert_array_equal(g.transform, w.transform)
            else:
                assert np.isclose(g.score, w.score, rtol=1e-6, atol=0)
                np.testing.assert_allclose(g.transform, w.transform, rtol=0,
                                           atol=1e-5)


@pytest.mark.parametrize("mesh_shape,axes", [
    ((4,), ("bank",)),
    ((2, 4), ("scene", "bank")),
])
def test_bank_sharded_matches_single_device(mesh_shape, axes):
    templates, scenes = _bank_and_scenes()
    lengths = ot.get_template_lengths(templates)
    kw = dict(top_k=5, penalty=ot.ExponentialPenalty(1.5),
              template_lengths=lengths)
    args = (scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
            ot.BatchOptimize(10))
    single = ot.match_many(*args, device="cpu", **kw)
    banked = match_many_bank_sharded(*args, mesh=_mesh(mesh_shape, axes), **kw)
    assert all(len(b) == 5 for b in banked)
    _assert_same(banked, single, exact=True)

    jax_banked = jax_bank_sharded(
        scenes, templates, jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2),
        jof.DefaultSearch(4, 10), jof.BatchOptimize(10),
        mesh=jax_make_mesh(shape=mesh_shape, axis_names=axes), top_k=5,
        penalty=jof.ExponentialPenalty(1.5), template_lengths=lengths)
    _assert_same(banked, jax_banked, exact=False)


def test_bank_sharded_no_penalty_and_chunking():
    templates, scenes = _bank_and_scenes(n_tmpl=9, n_scenes=5)
    args = (scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
            ot.BatchOptimize(10))
    single = ot.match_many(*args, top_k=3, device="cpu")
    # scene_chunk=2 forces three dispatches, the last padded
    banked = match_many_bank_sharded(*args, mesh=_mesh((2, 2), ("scene", "bank")),
                                     top_k=3, scene_chunk=2)
    _assert_same(banked, single, exact=True)


def test_prepare_bank_shards_padding():
    templates, _ = _bank_and_scenes(n_tmpl=10)
    sh = prepare_bank_shards(templates, 4)
    assert sh["t_shard"] == 3 and sh["lines"].shape[0] == 12
    assert sh["counts"][10] == 0 and sh["counts"][11] == 0
    assert isinstance(sh["lines"], np.ndarray)        # nothing uploaded
    ref = jax_prepare_bank_shards(templates, 4)
    for key in ("lines", "mask", "line_lengths", "counts", "tmpl_lengths"):
        np.testing.assert_array_equal(sh[key], ref[key])
    assert (sh["t_shard"], sh["t_real"], sh["lmax"]) == \
        (ref["t_shard"], ref["t_real"], ref["lmax"])


def test_bank_sharded_empty_scene():
    templates, scenes = _bank_and_scenes(n_tmpl=6, n_scenes=2)
    scenes = [np.zeros((0, 4), np.float32)] + scenes
    res = match_many_bank_sharded(
        scenes, templates, PARAMS, ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
        mesh=_mesh((4,), ("bank",)), top_k=3)
    assert res[0] == [] and all(len(r) > 0 for r in res[1:])


def test_bank_sharded_topk_wider_than_shard():
    """A ``top_k`` wider than one shard's candidates still returns
    ``min(top_k, total)`` matches after the re-rank."""
    templates, scenes = _bank_and_scenes(n_tmpl=8, n_scenes=1)
    args = (scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
            ot.BatchOptimize(10))
    single = ot.match_many(*args, top_k=60, device="cpu")
    banked = match_many_bank_sharded(*args, mesh=_mesh((4,), ("bank",)),
                                     top_k=60)
    assert len(banked[0]) == len(single[0]) > 0
    _assert_same(banked, single, exact=True)


def test_bank_sharded_rejects_a_user_penalty():
    templates, scenes = _bank_and_scenes(n_tmpl=4, n_scenes=1)

    class Halve(ot.DefaultPenalty):
        pass

    with pytest.raises(ValueError, match="power-form"):
        match_many_bank_sharded(scenes, templates, PARAMS,
                                ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
                                mesh=_mesh((2,), ("bank",)), top_k=3,
                                penalty=Halve())
