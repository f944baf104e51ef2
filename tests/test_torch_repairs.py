"""Faults of the port, repaired (the first four against the JAX package):

* a window generation that cannot serve a dispatch's canvas (generation 2
  below 256 px, generation 3 off multiples of 128) runs generation 4's
  windows on K1, as the JAX package's ``kernel_supported`` sends such
  canvases to its XLA path;
* the penalty's power is ``pow_f32`` (f64, then rounded), equal on the
  host and in the device top-k;
* a dispatch that exceeds the device budget splits along the template axis
  (top-k path) or the pair axis (host path), with results equal to the
  unsplit run;
* ``IndulgentOptimize.get_number_of_passthroughs``;
* the dispatch budget counts the caching allocator's unused blocks as
  free, so an earlier dispatch's cache does not split the next one;

and four places where the port answered a JAX signature differently:

* ``core.integral.line_integral_stack`` takes one ``(D, PH, PW)`` stack
  with an optional ``logical_hw`` and returns a new tensor (the batched,
  in-place sweep is ``line_integral_stack_batch_``);
* ``featuremap.propagate_orientation(dt3, wmat)`` is the dense min-plus
  closure (K3's relaxation is ``propagate_orientation_relax``);
* ``featuremap.classify_lines(angles, lines)`` takes the angle table and
  returns int32 indices;
* ``mesh`` is the last positional parameter of ``build_featuremap_batch``,
  ``match_many`` and ``match_many_async``; ``device`` and ``timer`` are
  keyword-only;

and two more found by comparing the packages' signatures
(``tests/test_torch_imports.py::test_port_takes_the_jax_parameters``):

* ``featuremap.evaluate_batched`` takes ``take_fn``, the pluggable probe
  gather;
* ``matching.featuremap`` re-exports ``dt_from_indicator``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openfdcm_tpu as of
from openfdcm_tpu.core import integral as jintegral
from openfdcm_tpu.matching import featuremap as jfm
import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.core import integral as tintegral
from openfdcm_tpu_torch.core.geometry import pow_f32
from openfdcm_tpu_torch.matching import featuremap as tfm
from openfdcm_tpu_torch.matching import optimize_kernel as tok
from openfdcm_tpu_torch.matching import pipeline as tpipe
from tests.torch_cases import assert_same_matches, three_scene_problem

torch.set_num_threads(1)

TOP_K = 5


def _small_canvas_problem():
    """Scenes small enough for a 128-px canvas at padding 1."""
    scenes, templates = three_scene_problem()
    return ([s * np.float32(0.4) for s in scenes],
            [t * np.float32(0.4) for t in templates])


# (generation, problem, params, pad_to, the canvas side it must give)
GATE_CASES = {
    "gen2-128": (2, _small_canvas_problem, (4, 5.0, 1.0), 128, 128),
    "gen3-350": (3, three_scene_problem, (4, 5.0, 2.2), 1, 350),
}


@pytest.fixture(scope="module")
def gate_jax():
    out = {}
    for name, (_, problem, p, pad_to, _) in GATE_CASES.items():
        scenes, templates = problem()
        out[name] = of.match_many(
            scenes, templates, of.Dt3Params(*p, of.Distance.L2),
            of.DefaultSearch(4, 10), of.DefaultOptimize(),
            penalty=of.ExponentialPenalty(1.5), top_k=TOP_K, pad_to=pad_to)
    return out


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_generation_gate_runs_k1_where_the_canvas_cannot_be_served(
        name, gate_jax, monkeypatch):
    version, problem, p, pad_to, side = GATE_CASES[name]
    scenes, templates = problem()
    params = ot.Dt3Params(*p, ot.Distance.L2)
    fms = ot.build_featuremap_batch(scenes[:1], params, pad_to=pad_to,
                                    device="cpu")
    assert fms.dt3.shape[-2:] == (side, side)
    run = lambda: ot.match_many(
        scenes, templates, params, ot.DefaultSearch(4, 10),
        ot.DefaultOptimize(), penalty=ot.ExponentialPenalty(1.5),
        top_k=TOP_K, pad_to=pad_to, device="cpu")
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", "4")
    want = run()

    def refuse(*args, **kw):
        raise AssertionError("a generation-2/3 window kernel was reached")
    for mod, names in ((tok.wk2, ("window_scores_v2", "window_scores_v2_ext")),
                       (tok.wk3, ("window_scores_v3", "window_scores_v3_ext"))):
        for attr in names:
            monkeypatch.setattr(mod, attr, refuse)
    main_passes = []
    k1 = tok.wk.window_scores

    def counted(*args, **kw):
        main_passes.append(kw["two_sided"])
        return k1(*args, **kw)
    monkeypatch.setattr(tok.wk, "window_scores", counted)
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    got = run()
    assert sum(main_passes) >= 1             # K1 main passes ran
    assert_same_matches(got, want, exact=True)
    assert_same_matches(got, gate_jax[name])


def test_window_generation_by_shape(monkeypatch):
    for version, shape, want in ((2, (1, 4, 128, 128), 4), (2, (1, 4, 256, 256), 2),
                                 (2, (1, 4, 300, 300), 2), (2, (1, 4, 384, 256), 4),
                                 (3, (1, 4, 350, 350), 4), (3, (1, 4, 384, 384), 3),
                                 (3, (1, 4, 128, 128), 3), (3, (1, 4, 256, 128), 4),
                                 (4, (1, 4, 37, 37), 4)):
        monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
        assert tok.window_generation(shape) == want, (version, shape)


def test_pow_f32_is_correctly_rounded():
    """1M f32 lengths in [1, 5000] at tau 1.5 (and two more exponents):
    ``pow_f32`` equals numpy's f64 power rounded to f32 everywhere."""
    rng = np.random.default_rng(0)
    x = rng.uniform(1, 5000, 1_000_000).astype(np.float32)
    for tau in (1.5, 1.3, 2.0):
        want = np.power(x.astype(np.float64),
                        np.float64(np.float32(tau))).astype(np.float32)
        got = pow_f32(torch.as_tensor(x), tau).numpy()
        assert int((got != want).sum()) == 0, tau


def test_host_penalty_equals_device_penalty():
    rng = np.random.default_rng(1)
    lengths = rng.uniform(0, 3000, 4096).astype(np.float32)
    lengths[:3] = (0.0, 1e-7, 1e-6)
    scores = rng.uniform(0, 1e5, 4096).astype(np.float32)
    for penalty, tau in ((ot.ExponentialPenalty(1.5), 1.5),
                         (ot.ExponentialPenalty(0.7), 0.7),
                         (ot.DefaultPenalty(), 1.0)):
        host = penalty.apply(scores, lengths)
        dev = (torch.as_tensor(scores)
               / pow_f32(torch.clamp_min(torch.as_tensor(lengths), 1e-6), tau))
        np.testing.assert_array_equal(host, dev.numpy())


def _spy(monkeypatch, module, attr):
    calls = []
    fn = getattr(module, attr)

    def spy(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)
    monkeypatch.setattr(module, attr, spy)
    return calls


@pytest.mark.parametrize("path", ["devpairs", "host", "host-topk-user-penalty",
                                  "host-topk-subclass"])
def test_chunked_equals_unchunked(path, monkeypatch):
    """A small device budget splits every dispatch (one scene, and one
    template or 64 pairs, per dispatch); ids, scores and transforms equal
    the unsplit run's."""
    scenes, templates = three_scene_problem()
    params = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)

    class Subclass(ot.DefaultSearch):
        pass

    class UserPenalty:
        def apply(self, score, length):
            return score / np.maximum(length, np.float32(1.0))

    searcher = Subclass(4, 10) if path == "host-topk-subclass" \
        else ot.DefaultSearch(4, 10)
    penalty = UserPenalty() if path == "host-topk-user-penalty" \
        else ot.ExponentialPenalty(1.5)
    top_k = None if path == "host" else TOP_K
    run = lambda: ot.match_many(scenes, templates, params, searcher,
                                ot.BatchOptimize(10), penalty=penalty,
                                top_k=top_k, device="cpu")
    target = ("_search_device_batch_topk_genpairs" if path == "devpairs"
              else "_search_chunk_dispatch")
    calls = _spy(monkeypatch, tpipe, target)
    whole = run()
    n_whole = len(calls)
    monkeypatch.setattr(tpipe, "CPU_BUDGET", 1)
    split = run()
    if path == "devpairs":
        assert (n_whole, len(calls) - n_whole) == (1, 3 * len(templates))
    else:
        assert (n_whole, len(calls) - n_whole) == (1, 3)
    assert sum(map(len, whole)) > 0
    assert_same_matches(split, whole, exact=True)


def test_pair_axis_split_into_parts(monkeypatch):
    """The host path's pair axis splits into 64-pair parts under a small
    budget, and the parts scatter back into emplace order."""
    scenes, templates = three_scene_problem()
    params = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
    fms = ot.build_featuremap_batch(scenes, params, device="cpu")
    bank = ot.prepare_templates(templates, device="cpu")
    args = (ot.DefaultSearch(4, 10), ot.BatchOptimize(10), fms, bank, scenes)
    whole = tpipe._search_batch_arrays(*args, scene_chunk=3)
    calls = _spy(monkeypatch, tpipe, "_search_device_batch")
    monkeypatch.setattr(tpipe, "CPU_BUDGET", 1)
    split = tpipe._search_batch_arrays(*args, scene_chunk=3)
    n_pairs = max(w[0].shape[0] for w in whole)
    assert n_pairs > 64 and len(calls) == -(-n_pairs // 64)
    for w, s in zip(whole, split):
        for a, b in zip(w, s):
            np.testing.assert_array_equal(a, b)


def test_indulgent_number_of_passthroughs():
    assert ot.IndulgentOptimize(3).get_number_of_passthroughs() == 3
    assert ot.IndulgentOptimize().get_number_of_passthroughs() == \
        of.IndulgentOptimize().get_number_of_passthroughs()


def test_budget_counts_cached_blocks_as_free(monkeypatch):
    """On the card the budget is a quarter of the free memory plus what
    the caching allocator holds unused: a repeated run plans the same
    dispatches as the first (a whole-bank run once split in two because
    the first run's cache had left less free memory)."""
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (40 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 12 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 4 * gib)
    assert tpipe._budget(torch.device("cuda", 0)) == 12 * gib
    assert tpipe._budget(torch.device("cpu")) == tpipe.CPU_BUDGET


def test_line_integral_stack_takes_the_jax_contract():
    """A ``(D, PH, PW)`` stack, ``logical_hw`` omitted or given: the JAX
    package's result bit for bit, and the input left as it was."""
    rng = np.random.default_rng(7)
    angles = list(tfm.make_angles(6))
    imgs = rng.uniform(0, 9, (6, 24, 40)).astype(np.float32)
    for lhw in (None, (20, 31)):
        x = imgs.copy()
        if lhw is not None:
            x[:, lhw[0]:, :] = 0.0
            x[:, :, lhw[1]:] = 0.0
        given = torch.tensor(x)
        got = tintegral.line_integral_stack(given, angles, lhw)
        want = np.asarray(jintegral.line_integral_stack(jnp.asarray(x), angles,
                                                        logical_hw=lhw))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(given.numpy(), x)


def test_propagate_orientation_takes_wmat():
    """``propagate_orientation(dt3, wmat)``: the JAX package's closure, bit
    for bit, on a stack with empty (infinite) slices."""
    rng = np.random.default_rng(8)
    angles = jfm.make_angles(6)
    dt3 = rng.uniform(0, 40, (6, 12, 17)).astype(np.float32)
    dt3[2] = np.inf
    wmat = jfm.propagation_weights(angles, 5.0)
    want = np.asarray(jfm.propagate_orientation(jnp.asarray(dt3), jnp.asarray(wmat)))
    got = tfm.propagate_orientation(torch.as_tensor(dt3), torch.as_tensor(wmat))
    np.testing.assert_array_equal(got.numpy(), want)


def test_classify_lines_takes_the_angle_table():
    rng = np.random.default_rng(9)
    lines = rng.uniform(-50, 50, (300, 4)).astype(np.float32)
    lines[:3] = [[3, 3, 3, 3], [1, 1, 1, 9], [0, 0, 5, -5]]
    for angles in (jfm.make_angles(8), jnp.asarray(jfm.make_angles(30))):
        want = np.asarray(jfm.classify_lines(jnp.asarray(angles), jnp.asarray(lines)))
        got = tfm.classify_lines(np.asarray(angles), torch.as_tensor(lines))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_mesh_is_the_last_positional_parameter():
    """A positional ``mesh`` (two ``cpu`` entries on ``"scene"``) gives the
    meshed result, as in the JAX package; ``device`` is keyword-only."""
    from openfdcm_tpu_torch.parallel import make_mesh
    scenes, templates = three_scene_problem()
    params = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
    mesh = make_mesh((2,), ("scene",), devices=[torch.device("cpu")] * 2)
    got = ot.build_featuremap_batch(scenes, params, 128, mesh)
    want = ot.build_featuremap_batch(scenes, params, 128, mesh=mesh)
    assert torch.equal(got.dt3, want.dt3)
    args = (scenes, templates, params, ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
            ot.ExponentialPenalty(1.5), None, 128, None, TOP_K)
    positional = ot.match_many(*args, mesh)
    assert_same_matches(positional, ot.match_many(*args, mesh=mesh), exact=True)
    assert_same_matches(ot.match_many_async(*args, mesh)(), positional, exact=True)
    with pytest.raises(TypeError):
        ot.match_many(*args, None, "cpu")


def test_evaluate_batched_take_fn_matches_jax():
    """The same custom gather (wrap-around instead of the clamp) through
    both packages: bit-equal scores.  The stack holds small integers, so
    the packages' line sums are exact in any order; the probes leave the
    stack, so the gather changes the scores."""
    rng = np.random.default_rng(10)
    d, h, w = 3, 16, 20
    dt3 = rng.integers(0, 50, d * h * w).astype(np.float32)
    si = rng.integers(0, d, (2, 5, 7)).astype(np.int32)
    ep = rng.uniform(-4, 24, (2, 5, 7, 2, 2)).astype(np.float32)
    lm = rng.uniform(size=(2, 5, 7)) < 0.8
    trs = rng.uniform(-30, 30, (2, 5, 9, 2)).astype(np.float32)
    n = dt3.size
    jx = [jnp.asarray(x) for x in (si, ep, lm, trs)]
    tx = [torch.as_tensor(x) for x in (si, ep, lm, trs)]
    want = np.asarray(jfm.evaluate_batched(
        jnp.asarray(dt3), (h, w), *jx, take_fn=lambda f, i: jnp.take(f, i % n)))
    got = tfm.evaluate_batched(torch.as_tensor(dt3), (h, w), *tx,
                               take_fn=lambda f, i: f[i % n])
    np.testing.assert_array_equal(got.numpy(), want)
    clamped = tfm.evaluate_batched(torch.as_tensor(dt3), (h, w), *tx)
    np.testing.assert_array_equal(
        clamped.numpy(), np.asarray(jfm.evaluate_batched(jnp.asarray(dt3), (h, w), *jx)))
    assert not torch.equal(got, clamped)


def test_featuremap_reexports_dt_from_indicator():
    from openfdcm_tpu_torch.matching.featuremap import dt_from_indicator
    rng = np.random.default_rng(11)
    ind = np.where(rng.uniform(size=(2, 24, 31)) < 0.03, 0.0,
                   np.finfo(np.float32).max).astype(np.float32)
    for metric in (of.Distance.L1, of.Distance.L2, of.Distance.L2_SQUARED):
        want = np.asarray(jfm.dt_from_indicator(jnp.asarray(ind), metric=metric))
        got = dt_from_indicator(torch.as_tensor(ind),
                                metric=getattr(ot.Distance, metric.name))
        np.testing.assert_array_equal(got.numpy(), want)
