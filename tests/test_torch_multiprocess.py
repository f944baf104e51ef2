"""A mesh over two processes: two spawned gloo ranks (a ``file://``
rendezvous under the test's directory), each with four ``cpu`` entries,
against the JAX package's sharded calls on conftest's eight virtual devices
and against the single-process port.

The problem is ``scripts/bench_multihost.py``'s, made with numpy from its
seed: a 10-line template, 2 scenes of 64 candidates, depth 4, ``window=10``,
``dense_steps=1``, under ``mode="batch"`` and ``"default"``.  Bars: validity
bit-equal to JAX; scores within rel 3e-7 of JAX (K1 sums lines in line
order) and bit-equal to the single-process port; translations within atol
1e-5 of JAX; ``global_topk`` ids and values identical to JAX's, ties
included.  The ranks run once for the module (``ranks``); the entry points
that stay single-controller refuse such a mesh here and in the ranks; the
ranks import no JAX."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import openfdcm_tpu as jof
import openfdcm_tpu_torch as ot
from openfdcm_tpu.parallel import (
    global_topk as jax_global_topk, make_mesh as jax_make_mesh,
    optimize_candidates_sharded as jax_sharded,
    optimize_candidates_sharded_batch as jax_batch)
from openfdcm_tpu_torch.matching.optimize_kernel import \
    optimize_candidates_batch_kernel
from openfdcm_tpu_torch.parallel import (
    Mesh, build_featuremap_spatial, make_mesh, match_many_bank_sharded,
    search_spatial)
from tests import torch_dist_worker

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODES = ("batch", "default")
K = 8


def _problem():
    """``scripts/bench_multihost.py``'s inputs, the DT3 from the JAX
    package's build."""
    rng = np.random.default_rng(3)
    n_lines, c, s = 10, 64, 2
    tmpl = np.zeros((n_lines, 4), np.float32)
    tmpl[:, 0:2] = rng.uniform(5, 40, (n_lines, 2)).astype(np.float32)
    tmpl[:, 2:4] = tmpl[:, 0:2] + rng.uniform(3, 12, (n_lines, 2)).astype(np.float32)
    fm = jof.build_featuremap(tmpl, jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2))
    _, ph, pw = fm.dt3.shape
    w, h = fm.feature_size
    ang = rng.uniform(0, 2 * np.pi, (s, c)).astype(np.float32)
    tie = rng.integers(0, 4, c).astype(np.float32)
    return dict(
        dt3_flat=np.tile(np.asarray(fm.dt3).reshape(1, -1), (s, 1)),
        angles=np.array(fm.angles),
        tr=np.tile(np.array(fm.scene_translation)[None], (s, 1)),
        hw=np.asarray([ph, pw]),
        fs=np.tile(np.asarray([[float(w), float(h)]], np.float32), (s, 1)),
        lines=np.tile(tmpl[None, None], (s, c, 1, 1)).astype(np.float32),
        mask=np.ones((s, c, n_lines), bool),
        av=np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32),
        tie_scores=tie, tie_valid=rng.uniform(size=c) < 0.8, k=np.asarray(K))


def _port_single(p, mode):
    """The single-process port: one kernel call over both scenes."""
    s, _ = p["dt3_flat"].shape
    ph, pw = p["hw"].tolist()
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    return optimize_candidates_batch_kernel(
        t["dt3_flat"].reshape(s, -1, ph, pw), t["angles"], t["tr"], t["fs"],
        t["lines"], t["mask"], t["av"], mode=mode, window=10, dense_steps=1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once, compute the JAX side and the single-process
    port meanwhile, and return ``(problem, jax results, port results, the
    ranks' records)``."""
    if not torch.distributed.is_available():
        pytest.skip("torch.distributed is not built in")
    tmp = tmp_path_factory.mktemp("mesh2")
    p = _problem()
    single = {m: _port_single(p, m) for m in MODES}
    p["real_scores"] = single["batch"][0][0].numpy()
    p["real_valid"] = single["batch"][2][0].numpy()
    np.savez(tmp / "problem.npz", **p)
    ctx = mp.spawn(torch_dist_worker.run_mesh,
                   args=(2, str(tmp / "rendezvous"), str(tmp / "problem.npz"),
                         str(tmp)), nprocs=2, join=False)
    try:
        jx = {k: jnp.asarray(v) for k, v in p.items()}
        hw = tuple(p["hw"].tolist())
        args = (jx["dt3_flat"], jx["angles"], jx["tr"], hw, jx["fs"],
                jx["lines"], jx["mask"], jx["av"])
        mesh2 = jax_make_mesh(shape=(2, 4), axis_names=("scene", "cand"))
        mesh8 = jax_make_mesh(shape=(8,), axis_names=("cand",))
        jres = {f"batch_{m}": [np.asarray(x) for x in jax_batch(
            mesh2, *args, mode=m, window=10, dense_steps=1)] for m in MODES}
        jres["cand8"] = [np.asarray(x) for x in jax_sharded(
            mesh8, jx["dt3_flat"][0], jx["angles"], jx["tr"][0], hw, jx["fs"][0],
            jx["lines"][0], jx["mask"][0], jx["av"][0], mode="batch",
            window=10, dense_steps=1)]
        for case in ("real", "tie"):
            jres[f"topk_{case}"] = [np.asarray(x) for x in jax_global_topk(
                mesh8, jx[f"{case}_scores"], jx[f"{case}_valid"], k=K)]
    finally:
        deadline = time.monotonic() + 180
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail("the two ranks did not finish within 180 s")
    seen = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(2)]
    return p, jres, single, seen


def _whole(shape, shards, dtype):
    """The tensor the shards of every rank make up; every cell must be in
    one of them."""
    out = torch.zeros(tuple(shape), dtype=dtype)
    held = torch.zeros(tuple(shape), dtype=torch.bool)
    for index, data, _ in shards:
        at = tuple(slice(a, b) for a, b in index)
        out[at], held[at] = data, True
    assert held.all()
    return out


@pytest.mark.parametrize("mode", MODES)
def test_sharded_batch_across_two_processes(ranks, mode):
    """A ``(scene 2, cand 4)`` mesh over two processes: each rank holds the
    four blocks of its scene row, bit-equal to the single-process port's
    rows, and the whole within the bars of the JAX package's call."""
    p, jres, single, seen = ranks
    shards = [[], [], []]
    for rank, rec in enumerate(seen):
        for i, (shape, sh) in enumerate(rec[f"batch_{mode}"]):
            assert tuple(shape) == tuple(single[mode][i].shape)
            assert [ix[0] for ix, _, _ in sh] == [[rank, rank + 1]] * 4
            assert [ix[1] for ix, _, _ in sh] == [[16 * j, 16 * (j + 1)] for j in range(4)]
            for index, data, dev in sh:
                assert dev == "cpu"
                want = single[mode][i][tuple(slice(a, b) for a, b in index)]
                assert torch.equal(data, want)
            shards[i] += sh
    scores, trans, valid = (_whole(s.shape, sh, s.dtype)
                            for s, sh in zip(single[mode], shards))
    js, jt, jv = jres[f"batch_{mode}"]
    np.testing.assert_array_equal(valid.numpy(), jv)
    ok = jv
    assert ok.any()
    np.testing.assert_allclose(scores.numpy()[ok], js[ok], rtol=3e-7, atol=0)
    np.testing.assert_allclose(trans.numpy()[ok], jt[ok], rtol=0, atol=1e-5)


def test_sharded_one_axis_across_two_processes(ranks):
    """``optimize_candidates_sharded`` on a ``cand 8`` mesh over the two
    processes: four blocks a rank, bit-equal to the single-process port's
    scene 0 and within the bars of the JAX package's call."""
    p, jres, single, seen = ranks
    got = [[], [], []]
    for rank, rec in enumerate(seen):
        for i, (shape, sh) in enumerate(rec["cand8"]):
            assert [ix[0] for ix, _, _ in sh] == [[8 * j, 8 * (j + 1)]
                                                  for j in range(4 * rank, 4 * rank + 4)]
            for index, data, _ in sh:
                want = single["batch"][i][0][tuple(slice(a, b) for a, b in index)]
                assert torch.equal(data, want)
            got[i] += sh
    valid = _whole((64,), got[2], torch.bool)
    js, jt, jv = jres["cand8"]
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_allclose(_whole((64,), got[0], torch.float32).numpy()[jv],
                               js[jv], rtol=3e-7, atol=0)
    np.testing.assert_allclose(_whole((64, 2), got[1], torch.float32).numpy()[jv],
                               jt[jv], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ("real", "tie"))
def test_global_topk_across_two_processes(ranks, case):
    """``global_topk`` on a ``cand 8`` mesh over the two processes: both
    ranks return the JAX package's ids and values; with ties (scores in
    {0, 1, 2, 3}) the order is (score, global index)."""
    p, jres, _, seen = ranks
    want_v, want_i = jres[f"topk_{case}"]
    masked = np.where(p[f"{case}_valid"], p[f"{case}_scores"], np.inf)
    order = np.lexsort((np.arange(masked.size), masked))[:K]
    np.testing.assert_array_equal(want_i, order)
    for rec in seen:
        vals, idx = rec[f"topk_{case}"]
        np.testing.assert_array_equal(idx.numpy(), want_i)
        np.testing.assert_array_equal(vals.numpy(), want_v)
    if case == "tie":
        assert len(set(masked[order].tolist())) < K


def test_collectives_across_two_processes(ranks):
    """The mesh's collectives along a line over two processes give each
    owner what the single-process collective gives."""
    _, _, _, seen = ranks
    parts = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * i
             for i in range(8)]
    blocks = [torch.arange(16, dtype=torch.int32).reshape(8, 2) + 100 * i
              for i in range(8)]
    a2a = Mesh.all_to_all(blocks, 0, 1, [CPU] * 8)
    for rank, rec in enumerate(seen):
        got = rec["collectives"]
        assert torch.equal(got["all_gather"], Mesh.all_gather(parts, CPU, dim=1))
        assert torch.equal(got["psum"], Mesh.psum(parts, CPU))
        for j, x in enumerate(got["all_to_all"]):
            assert (x is None) == (j // 4 != rank)
            assert x is None or torch.equal(x, a2a[j])
        assert torch.equal(got["bools"], torch.tensor([True, False] * 8))
        assert [r.tolist() for r in got["ranks"]] == [[[0, 0]], [[1, 1], [1, 1]]]
    assert seen[0]["collectives"]["ppermute"] is None
    assert torch.equal(seen[1]["collectives"]["ppermute"],
                       torch.tensor([[1.5, -2.0], [3.0, 7.25]]))


def test_global_device_list_and_ranks(ranks):
    """``make_mesh(devices=None)`` in a process group: every rank's visible
    cards, ranks in order (rank 0 saw one card, rank 1 two); each rank knows
    its index and the mesh spans processes."""
    _, _, _, seen = ranks
    for rank, rec in enumerate(seen):
        assert (rec["rank"], rec["world"], rec["local2"]) == (rank, 2, False)
        assert rec["global"] == (["cuda:0", "cuda:0", "cuda:1"], [0, 1, 1])


def test_ranks_refuse_match_many_and_import_no_jax(ranks):
    _, _, _, seen = ranks
    for rec in seen:
        assert "match_many runs under one controller" in rec["match_many"]
        assert "processes [0, 1]" in rec["match_many"]
        assert rec["jax"] == []


def test_a_dead_rank_fails_the_call(ranks):
    """Rank 1 exits; rank 0's next ``global_topk`` raises, it does not
    hang or answer from its own blocks."""
    _, _, _, seen = ranks
    assert seen[0]["dead_peer"].startswith("RuntimeError")


# -- the mesh of two processes, seen from this process (no group: process 0)

def _two_process_mesh(shape=(2,), axes=("scene",)):
    n = int(np.prod(shape))
    return make_mesh(shape, axes, devices=[(i * 2 // n, CPU) for i in range(n)])


def test_mesh_records_the_process_of_each_entry():
    mesh = _two_process_mesh((2, 2), ("scene", "cand"))
    assert mesh.processes.tolist() == [[0, 0], [1, 1]]
    assert (mesh.process(scene=1, cand=0), mesh.owners("scene", cand=1)) == (1, [0, 1])
    assert not mesh.local and "processes=[0, 1]" in repr(mesh)
    assert [c for c, _ in mesh.own_entries()] == [dict(scene=0, cand=0),
                                                 dict(scene=0, cand=1)]
    assert mesh != make_mesh((2, 2), ("scene", "cand"), devices=[CPU] * 4)
    assert make_mesh((2,), ("cand",), devices=[CPU] * 2).local


def _spatial_search():
    fm = ot.build_featuremap(np.asarray([[0, 0, 20, 10]], np.float32),
                             ot.Dt3Params(4, 5.0, 2.2), device="cpu")
    return lambda mesh: search_spatial(ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
                                       fm, [], np.zeros((1, 4), np.float32),
                                       mesh=mesh)


SCENE = [np.asarray([[0, 0, 20, 10], [3, 4, 9, 30]], np.float32)]
ARGS = (SCENE, SCENE, ot.Dt3Params(4, 5.0, 2.2), ot.DefaultSearch(4, 10),
        ot.BatchOptimize(10))
SINGLE_CONTROLLER = {
    "match_many": lambda m: ot.match_many(*ARGS, top_k=2, mesh=m),
    "match_many_async": lambda m: ot.match_many_async(*ARGS, top_k=2, mesh=m),
    "build_featuremap_batch": lambda m: ot.build_featuremap_batch(SCENE, mesh=m),
    "search": lambda m: ot.search(ot.DefaultMatch(), *ARGS[3:], ot.build_featuremap(
        SCENE[0], ARGS[2], device="cpu"), SCENE, SCENE[0], mesh=m),
    "search_batch": lambda m: ot.search_batch(
        ot.DefaultMatch(), *ARGS[3:], ot.build_featuremap_batch(SCENE, ARGS[2],
                                                                device="cpu"),
        SCENE, SCENE, mesh=m),
    "MatcherService": lambda m: ot.MatcherService(SCENE, *ARGS[2:], top_k=2, mesh=m),
    "resumable_sweep": lambda m: ot.resumable_sweep(*ARGS, top_k=2, state_dir="",
                                                    mesh=m),
    "match_many_bank_sharded": lambda m: match_many_bank_sharded(*ARGS, mesh=m,
                                                                 top_k=2),
    "build_featuremap_spatial": lambda m: build_featuremap_spatial(SCENE[0], mesh=m),
    "search_spatial": lambda m: _spatial_search()(m),
}


@pytest.mark.parametrize("entry", sorted(SINGLE_CONTROLLER))
def test_single_controller_entry_points_refuse_a_mesh_over_processes(entry):
    """Each entry point that the JAX package cannot run across processes
    raises a ``ValueError`` naming itself, before any work."""
    with pytest.raises(ValueError, match=f"{entry} runs under one controller"):
        SINGLE_CONTROLLER[entry](_two_process_mesh())
