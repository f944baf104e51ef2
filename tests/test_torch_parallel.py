"""The port's candidate and scene sharding on a mesh of eight ``cpu``
entries: every sharded call equals the unsharded port bit for bit, and the
JAX package's sharded call on its eight virtual devices within the parity
bars (ids identical, unpenalized scores rel 3e-7, penalized rtol 1e-6,
transforms atol 1e-5, DT3 bit-equal).  Mirrors ``tests/test_parallel.py``."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openfdcm_tpu as jof
import openfdcm_tpu_torch as ot
from openfdcm_tpu.parallel import (global_topk as jax_global_topk,
                                   make_mesh as jax_make_mesh,
                                   optimize_candidates_sharded_batch as jax_batch)
from openfdcm_tpu_torch.matching.optimize_kernel import \
    optimize_candidates_batch_kernel
from openfdcm_tpu_torch.ops import build
from openfdcm_tpu_torch.parallel import (
    Mesh, global_topk, make_mesh, optimize_candidates_sharded_batch,
    pad_to_multiple, topk_candidates)
from tests.torch_cases import assert_same_matches, three_scene_problem
from tests.utils import create_lines, make_rotation

torch.set_num_threads(1)

CPU = torch.device("cpu")
PARAMS = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)


def _mesh(shape, axes):
    return make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


def _setup():
    tmpl = np.asarray(create_lines(10, 100.0))
    rot = make_rotation(np.pi)
    scene = ((tmpl.reshape(-1, 2) @ rot.T).reshape(-1, 4)
             + np.float32(3.0)).astype(np.float32)
    return tmpl, scene


def _close_to_jax(got, want):
    """Unpenalized results against the JAX package: ids identical, scores
    within rel 3e-7, transforms within atol 1e-5."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.tmpl_idx == w.tmpl_idx
        assert np.isclose(g.score, w.score, rtol=3e-7, atol=0)
        np.testing.assert_allclose(g.transform, w.transform, rtol=0, atol=1e-5)


def test_cand_mesh_search_matches_unsharded_and_jax():
    tmpl, scene = _setup()
    args = (ot.DefaultMatch(), ot.DefaultSearch(4, 10), ot.BatchOptimize(10))
    fm = ot.build_featuremap(scene, PARAMS, device="cpu")
    single = ot.search(*args, fm, [tmpl], scene)
    sharded = ot.search(*args, fm, [tmpl], scene, mesh=_mesh((8,), ("cand",)))
    assert assert_same_matches([sharded], [single], exact=True) > 0

    jfm = jof.build_featuremap(scene, jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2))
    jax_sharded = jof.search(jof.DefaultMatch(), jof.DefaultSearch(4, 10),
                             jof.BatchOptimize(10), jfm, [tmpl], scene,
                             mesh=jax_make_mesh(axis_names=("cand",)))
    _close_to_jax(sharded, jax_sharded)


def test_sharded_2d_scene_batch():
    """A ``("scene", 2) x ("cand", 4)`` mesh: each scene's row equals the
    unsharded kernel call's bit for bit and the JAX package's sharded call
    within its bars."""
    tmpl, scene = _setup()
    fm = ot.build_featuremap(scene, PARAMS, device="cpu")
    s_batch, c, l = 2, 8, 10
    rng = np.random.default_rng(0)
    lines = np.tile(tmpl[None, None], (s_batch, c, 1, 1))
    lines = (lines + rng.uniform(-2, 2, (s_batch, c, 1, 4))).astype(np.float32)
    mask = np.ones((s_batch, c, l), bool)
    mask[1, 3, 7:] = False
    av = np.tile(np.asarray([1.0, 0.0], np.float32)[None, None], (s_batch, c, 1))
    d, ph, pw = fm.dt3.shape
    w, h = fm.feature_size
    dt3_flat = fm.dt3.reshape(1, -1).repeat(s_batch, 1)
    tr = fm.scene_translation[None].repeat(s_batch, 1)
    fs = torch.tensor([[float(w), float(h)]] * s_batch)
    kw = dict(mode="batch", window=10, dense_steps=1)
    t = [torch.as_tensor(x) for x in (lines, mask, av)]

    got = optimize_candidates_sharded_batch(
        _mesh((2, 4), ("scene", "cand")), dt3_flat, fm.angles, tr, (ph, pw),
        fs, *t, **kw)
    want = optimize_candidates_batch_kernel(
        dt3_flat.reshape(s_batch, d, ph, pw), fm.angles, tr, fs, *t, **kw)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert got[0].shape == (s_batch, c) and bool(got[2].any())

    jfm = jof.build_featuremap(scene, jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2))
    js, jt, jv = jax_batch(
        jax_make_mesh(shape=(2, 4), axis_names=("scene", "cand")),
        jnp.tile(jfm.dt3.reshape(1, -1), (s_batch, 1)), jfm.angles,
        jnp.tile(jfm.scene_translation[None], (s_batch, 1)), (ph, pw),
        jnp.asarray(fs.numpy()), *(jnp.asarray(x) for x in (lines, mask, av)),
        **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jv))
    ok = got[2].numpy()
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(js)[ok],
                               rtol=3e-7, atol=0)
    np.testing.assert_allclose(got[1].numpy()[ok], np.asarray(jt)[ok],
                               rtol=0, atol=1e-5)


def test_topk_deterministic_ties():
    scores = torch.tensor([3.0, 1.0, 1.0, 2.0, 0.5, 0.5])
    valid = torch.tensor([True, True, True, True, False, True])
    vals, idx = topk_candidates(scores, valid, 4)
    np.testing.assert_array_equal(idx.numpy(), [5, 1, 2, 3])
    np.testing.assert_array_equal(vals.numpy(), [0.5, 1.0, 1.0, 2.0])


def test_global_topk_across_shards():
    mesh = _mesh((8,), ("cand",))
    c = 16 * 8
    rng = np.random.default_rng(0)
    scores = rng.uniform(0, 100, c).astype(np.float32)
    valid = rng.uniform(size=c) > 0.2
    scores[5] = scores[9] = scores[70] = 1.5          # ties across shards
    valid[5] = valid[9] = valid[70] = True
    vals, idx = global_topk(mesh, torch.as_tensor(scores),
                            torch.as_tensor(valid), 8)
    masked = np.where(valid, scores, np.inf)
    order = np.lexsort((np.arange(c), masked))[:8]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(), masked[order])
    jv, ji = jax_global_topk(jax_make_mesh(axis_names=("cand",)),
                             jnp.asarray(scores), jnp.asarray(valid), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    full = topk_candidates(torch.as_tensor(scores), torch.as_tensor(valid), 8)
    assert torch.equal(full[1], idx) and torch.equal(full[0], vals)


@pytest.mark.parametrize("n_cand,k", [(8, 30), (2, 24)])
def test_cand_mesh_topk_wider_than_shard(n_cand, k):
    """``match_many`` on a cand-only mesh (the host ranking path) with a
    ``top_k`` wider than one shard's share returns the unsharded rows."""
    tmpl, scene = _setup()
    args = ([scene], [tmpl, tmpl], PARAMS, ot.DefaultSearch(4, 10),
            ot.BatchOptimize(10))
    single = ot.match_many(*args, top_k=k, device="cpu")
    meshed = ot.match_many(*args, top_k=k, mesh=_mesh((n_cand,), ("cand",)))
    assert len(single[0]) == k
    assert assert_same_matches(meshed, single, exact=True) == k


def test_scene_mesh_build_and_match_many():
    """A ``("scene", 8)`` mesh: the build (three scenes padded to eight) is
    bit-equal to the unsharded port's and the JAX package's sharded build;
    ``match_many`` equals the unsharded port exactly and the JAX package's
    sharded call within its bars."""
    scenes, templates = three_scene_problem()
    mesh = _mesh((8,), ("scene",))
    ref = ot.build_featuremap_batch(scenes, PARAMS, device="cpu")
    sh = ot.build_featuremap_batch(scenes, PARAMS, mesh=mesh)
    assert torch.equal(sh.dt3, ref.dt3)
    assert torch.equal(sh.scene_translations, ref.scene_translations)
    jmesh = jax_make_mesh(shape=(8,), axis_names=("scene",))
    jparams = jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2)
    np.testing.assert_array_equal(
        sh.dt3.numpy(),
        np.asarray(jof.build_featuremap_batch(scenes, jparams, mesh=jmesh).dt3))

    kw = dict(penalty=ot.ExponentialPenalty(1.5),
              template_lengths=ot.get_template_lengths(templates), top_k=5)
    args = (scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
            ot.BatchOptimize(10))
    single = ot.match_many(*args, device="cpu", **kw)
    meshed = ot.match_many(*args, mesh=mesh, **kw)
    assert assert_same_matches(meshed, single, exact=True) == 15
    jax_meshed = jof.match_many(
        scenes, templates, jparams, jof.DefaultSearch(4, 10),
        jof.BatchOptimize(10), penalty=jof.ExponentialPenalty(1.5),
        template_lengths=kw["template_lengths"], top_k=5, mesh=jmesh)
    assert assert_same_matches(meshed, jax_meshed) == 15


@pytest.mark.parametrize("shape,axes", [((2, 2), ("scene", "cand")),
                                        ((4,), ("scene",))])
def test_meshed_host_ranking_and_search_batch(shape, axes):
    """The host ranking path (no ``top_k``) and ``search_batch`` on a mesh
    equal their unsharded calls, padding scene chunks to the scene axis."""
    scenes, templates = three_scene_problem()
    mesh = _mesh(shape, axes)
    args = (scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
            ot.BatchOptimize(10))
    assert assert_same_matches(ot.match_many(*args, mesh=mesh),
                               ot.match_many(*args, device="cpu"),
                               exact=True) > 0
    fms = ot.build_featuremap_batch(scenes, PARAMS, device="cpu")
    sargs = (ot.DefaultMatch(), ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
             fms, templates, scenes)
    assert assert_same_matches(ot.search_batch(*sargs, scene_chunk=1, mesh=mesh),
                               ot.search_batch(*sargs), exact=True) > 0


def test_make_mesh_and_device_rules(monkeypatch):
    """``make_mesh()`` takes the CUDA devices and raises without one; an
    explicit list may repeat a device; a mesh is hashable; a call given a
    mesh and a device outside it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    mesh = _mesh((2, 4), ("scene", "cand"))
    assert mesh.shape == {"scene": 2, "cand": 4} and mesh.devices.size == 8
    assert mesh.shape.get("bank", 1) == 1 and mesh.axis_size("rows") == 1
    assert mesh == _mesh((2, 4), ("scene", "cand"))
    assert len({mesh, _mesh((2, 4), ("scene", "cand")), _mesh((8,), ("cand",))}) == 2
    assert mesh.resolve() == CPU and mesh.resolve("cpu") == CPU
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh.resolve(torch.device("meta"))
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((8,), ("cand",), devices=[CPU] * 4)
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(12, 4) == 12
    scenes, templates = three_scene_problem()
    with pytest.raises(ValueError, match="not in the mesh"):
        ot.match_many(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                      ot.BatchOptimize(10), top_k=2, device="meta", mesh=mesh)


def test_mesh_collectives_and_replicas():
    """The collectives in shard order, and a bank table copied once per
    (tensor, device)."""
    x = torch.arange(24.0).reshape(4, 6)
    devs = [CPU] * 2
    parts = Mesh.split(x, devs)
    assert torch.equal(Mesh.all_gather(parts, CPU), x)
    assert torch.equal(Mesh.psum([x, torch.zeros_like(x), x], CPU), 2 * x)
    back = Mesh.all_to_all(Mesh.all_to_all(parts, 1, 0, devs), 0, 1, devs)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    cols = Mesh.all_to_all(parts, 1, 0, devs)
    assert torch.equal(torch.cat(cols, 1), x)
    mesh = _mesh((2,), ("cand",))
    assert mesh.replica(x, CPU) is x
    meta = torch.device("meta")
    first = mesh.replica(x, meta)
    assert first.device == meta and mesh.replica(x, meta) is first


def test_library_builds_and_loads_once(monkeypatch, tmp_path):
    """``ops/build.library()`` called from many shards at once builds and
    loads the library once and hands every caller the same handle."""
    built, loaded = [], []
    so = tmp_path / "lib.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_build():
        built.append(1)
        return so

    def fake_cdll(path):
        loaded.append(path)
        return FakeLib()

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    build.library.cache_clear()
    try:
        handles = [None] * 8
        start = threading.Barrier(8)

        def shard(i):
            start.wait()
            handles[i] = build.library()

        threads = [threading.Thread(target=shard, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(built) == len(loaded) == 1
        assert all(h is handles[0] for h in handles)
        assert build.library() is handles[0]
    finally:
        build.library.cache_clear()
