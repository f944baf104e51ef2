"""The port's row-sharded build and search on meshes of ``cpu`` entries:
the build is bit-equal on the logical region to the port's unsharded
``build_featuremap`` and to the JAX package's spatial build on its eight
virtual devices; ``search_spatial`` equals the unsharded ``search`` bit for
bit and the JAX package's ``search_spatial`` within the parity bars.
Mirrors ``tests/test_spatial.py``."""
import numpy as np
import pytest
import torch

import openfdcm_tpu as jof
import openfdcm_tpu_torch as ot
from openfdcm_tpu.parallel import make_mesh as jax_make_mesh
from openfdcm_tpu.parallel.spatial import (
    build_featuremap_spatial as jax_build_spatial,
    search_spatial as jax_search_spatial)
from openfdcm_tpu_torch.parallel import (RowShardedStack,
                                         build_featuremap_spatial, make_mesh,
                                         search_spatial)
from tests import utils
from tests.test_spatial import _scene
from tests.torch_cases import assert_same_matches

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _rows(n):
    return make_mesh((n,), ("rows",), devices=[CPU] * n)


def _logical(fm):
    w, h = fm.feature_size
    dt3 = fm.dt3.gather() if isinstance(fm.dt3, RowShardedStack) else fm.dt3
    return np.asarray(dt3)[:, :h, :w]


@pytest.mark.parametrize("metric", ["L2", "L1", "L2_SQUARED"])
def test_spatial_build_bit_equal(metric):
    scene = _scene()
    params = ot.Dt3Params(8, 5.0, 2.2, getattr(ot.Distance, metric))
    ref = ot.build_featuremap(scene, params, pad_to=128, device="cpu")
    sp = build_featuremap_spatial(scene, params, mesh=_rows(8), pad_to=128)
    assert sp.feature_size == ref.feature_size
    assert torch.equal(sp.scene_translation, ref.scene_translation)
    assert len(sp.dt3.blocks) == 8 and sp.dt3.shape[1] % 8 == 0
    np.testing.assert_array_equal(_logical(sp), _logical(ref))

    jsp = jax_build_spatial(
        scene, jof.Dt3Params(8, 5.0, 2.2, getattr(jof.Distance, metric)),
        mesh=jax_make_mesh(axis_names=("rows",)), pad_to=128)
    np.testing.assert_array_equal(sp.dt3.gather().numpy(), np.asarray(jsp.dt3))


@pytest.mark.parametrize("pad_to", [None, 64])
def test_spatial_build_uneven_padding(pad_to):
    """Physical H and W round up to ``lcm(pad_to, 8)``: 8 with no
    ``pad_to``, 64 with 64."""
    scene = _scene(n=10, length=40.0, seed=7)
    params = ot.Dt3Params(depth=5, distance=ot.Distance.L2)
    ref = ot.build_featuremap(scene, params, pad_to=None, device="cpu")
    sp = build_featuremap_spatial(scene, params, mesh=_rows(8), pad_to=pad_to)
    unit = 8 if pad_to is None else 64
    assert sp.dt3.shape[1] % unit == 0 and sp.dt3.shape[2] % unit == 0
    np.testing.assert_array_equal(_logical(sp), _logical(ref))
    jsp = jax_build_spatial(scene, jof.Dt3Params(depth=5, distance=jof.Distance.L2),
                            mesh=jax_make_mesh(axis_names=("rows",)),
                            pad_to=pad_to)
    np.testing.assert_array_equal(sp.dt3.gather().numpy(), np.asarray(jsp.dt3))


@pytest.mark.parametrize("optimizer", ["BatchOptimize", "DefaultOptimize",
                                       "DenseOptimize"])
def test_search_spatial_matches_single_device(optimizer):
    """The probes of every window are read through the row blocks, summed
    in block order (one value and zeros: exact)."""
    tmpl = np.asarray(utils.create_lines(8, 60.0))
    rot = utils.make_rotation(np.pi / 3)
    scene = np.concatenate([tmpl[:, 0:2] @ rot.T, tmpl[:, 2:4] @ rot.T],
                           axis=1).astype(np.float32) + np.float32(4.0)
    params = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
    make = {"BatchOptimize": lambda m: m.BatchOptimize(10),
            "DefaultOptimize": lambda m: m.DefaultOptimize(),
            "DenseOptimize": lambda m: m.DenseOptimize()}[optimizer]
    mesh = _rows(8)
    fm_dense = ot.build_featuremap(scene, params, device="cpu")
    fm_spatial = build_featuremap_spatial(scene, params, mesh=mesh, pad_to=16)
    single = ot.search(ot.DefaultMatch(), ot.DefaultSearch(4, 10), make(ot),
                       fm_dense, [tmpl], scene)
    sharded = search_spatial(ot.DefaultSearch(4, 10), make(ot), fm_spatial,
                             [tmpl], scene, mesh=mesh)
    assert assert_same_matches([sharded], [single], exact=True) > 0

    jparams = jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2)
    jmesh = jax_make_mesh(shape=(8,), axis_names=("rows",))
    jax_sharded = jax_search_spatial(
        jof.DefaultSearch(4, 10), make(jof),
        jax_build_spatial(scene, jparams, mesh=jmesh, pad_to=16), [tmpl], scene,
        mesh=jmesh)
    assert len(sharded) == len(jax_sharded)
    for g, w in zip(sharded, jax_sharded):
        assert g.tmpl_idx == w.tmpl_idx
        assert np.isclose(g.score, w.score, rtol=3e-7, atol=0)
        np.testing.assert_allclose(g.transform, w.transform, rtol=0, atol=1e-5)


def test_spatial_empty_scene_and_mismatched_mesh():
    params = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
    empty = build_featuremap_spatial(np.zeros((0, 4), np.float32), params,
                                     mesh=_rows(2))
    assert empty.feature_size == (0, 0)
    scene = _scene(n=6, length=30.0, seed=1)
    fm = build_featuremap_spatial(scene, params, mesh=_rows(2), pad_to=None)
    assert search_spatial(ot.DefaultSearch(4, 10), ot.BatchOptimize(10), fm,
                          [], scene, mesh=_rows(2)) == []
    with pytest.raises(ValueError, match="row blocks"):
        search_spatial(ot.DefaultSearch(4, 10), ot.BatchOptimize(10), fm,
                       [scene[:3]], scene, mesh=_rows(4))
