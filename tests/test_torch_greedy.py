"""The port's greedy walks (DefaultOptimize, IndulgentOptimize) and the
window-generation dispatch against the JAX package on the CPU.

Bars: chain decisions and walk states equal; the kernel-backed optimizer
under each window generation (2, 3, 4) and mode (default, indulgent,
batch) equal to the JAX package's kernel path in the Pallas interpreter,
with walks forced far beyond the covered window (translations and
validity bit-equal; ``best`` bit-equal under generations 2 and 3, which sum
a candidate's lines in the TPU kernels' order, and within rel 3e-7 under
generation 4, whose kernel K1 sums in line order); ``match_many`` with DefaultOptimize and
IndulgentOptimize under each generation against the JAX package's
``match_many``: top-k ids identical, scores rtol 1e-6, transforms atol
1e-5 (the bars of ``tests/test_torch_match.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import openfdcm_tpu as of
from openfdcm_tpu.matching import featuremap as jfm
from openfdcm_tpu.matching import optimize as jopt
from openfdcm_tpu.matching import optimize_kernel as jok
from openfdcm_tpu.ops import window_kernel as wk
import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.matching import optimize as topt
from openfdcm_tpu_torch.matching import optimize_kernel as tok
from tests.test_torch_match import TOP_K, _assert_same_topk, _problem

torch.set_num_threads(1)

MODES = {"default": 32, "indulgent": 32, "batch": 10}


def _chain_case(seed, m=48, h=60, tcov_small=False):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 30, (m, h)).astype(np.float32)
    scores[::3] = np.sort(scores[::3], axis=1)[:, ::-1]      # long descents
    scores[1::7, 5:9] = scores[1::7, 4:5]                    # ties
    t_lim = rng.integers(0, 90, m).astype(np.float32)
    tcov = (rng.integers(0, 25, m) if tcov_small
            else np.full(m, 63)).astype(np.float32)
    prev = rng.uniform(5, 40, m).astype(np.float32)
    done = rng.uniform(size=m) < 0.2
    t0 = rng.integers(1, 4, m).astype(np.float32)
    state = (prev, prev.copy(), np.zeros(m, np.float32), done, t0)
    return scores, t_lim, tcov, state


@pytest.mark.parametrize("tcov_small", [False, True])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_greedy_chain_cov_matches_jax(tcov_small, sign):
    scores, t_lim, tcov, state = _chain_case(2, tcov_small=tcov_small)
    want = jok._greedy_chain_cov(jnp.asarray(scores), jnp.asarray(t_lim),
                                 jnp.asarray(tcov),
                                 tuple(jnp.asarray(x) for x in state), sign)
    got = tok._greedy_chain_cov(torch.as_tensor(scores), torch.as_tensor(t_lim),
                                torch.as_tensor(tcov),
                                tuple(torch.as_tensor(x) for x in state), sign)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_greedy_walk_matches_jax(sign):
    """The lockstep greedy walk on one score table: ``eval_window(t0)``
    returns ``table[c, t0 + i]``, ``i < window``."""
    rng = np.random.default_rng(7)
    m, t_max, window = 40, 200, 8
    # mostly descending: walks run over several windows before an ascent
    table = np.cumsum(rng.uniform(-1.0, 0.03, (m, t_max)), axis=1).astype(np.float32)
    t_lim = rng.integers(5, 150, m).astype(np.float32)
    prev = rng.uniform(-5, 5, m).astype(np.float32)
    done = rng.uniform(size=m) < 0.15
    t0 = rng.integers(1, 30, m).astype(np.float32)
    state = (prev, prev.copy(), np.zeros(m, np.float32), done, t0)
    idx = np.arange(window)

    def jax_eval(t):
        cols = jnp.clip(t.astype(jnp.int32)[:, None] + idx[None, :], 0, t_max - 1)
        return jnp.take_along_axis(jnp.asarray(table), cols, axis=1)

    def port_eval(t):
        cols = (t.to(torch.int64)[:, None] + torch.as_tensor(idx)[None, :]).clamp(0, t_max - 1)
        return torch.gather(torch.as_tensor(table), 1, cols)

    want = jopt._greedy_walk(jax_eval, jnp.asarray(t_lim),
                             tuple(jnp.asarray(x) for x in state), sign, window)
    before = topt.host_sync.count
    got = topt._greedy_walk(port_eval, torch.as_tensor(t_lim),
                            tuple(torch.as_tensor(x) for x in state), sign, window)
    assert topt.host_sync.count - before > 3                # several windows
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture
def entry_calls(monkeypatch):
    """Generations whose main-pass entry (K5 or K6) was called."""
    calls = []
    for version, mod, name in ((2, tok.wk2, "window_scores_v2"),
                               (3, tok.wk3, "window_scores_v3")):
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _v=version, **kw):
            calls.append(_v)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.fixture(scope="module")
def optimize_inputs():
    """Scene 0: the DT decreases along +x, so x-major walks keep descending
    to their translation limit (extension passes and lockstep walks), and
    steep rays get a small ``tc`` under generations 2 and 3.  Scene 1:
    random values, short walks where DefaultOptimize and
    IndulgentOptimize part (mirrors ``test_v4_forced_stragglers_512``).
    13 candidates per scene, one masked line."""
    depth, q, c, l = 6, 256, 13, 4
    rng = np.random.default_rng(11)
    base = (np.arange(q, dtype=np.float32)[::-1] * 3.0)[None, :]
    ramp = np.broadcast_to(base, (depth, q, q)) \
        + rng.uniform(0, 0.5, (depth, q, q)).astype(np.float32)
    dt3 = np.stack([np.cumsum(ramp, axis=2, dtype=np.float32),
                    rng.uniform(0, 300, (depth, q, q)).astype(np.float32)])
    p1 = rng.uniform(40, 120, (2, c, l, 2)).astype(np.float32)
    d = rng.uniform(-12, 12, (2, c, l, 2)).astype(np.float32)
    cand = np.concatenate([p1, p1 + d], axis=-1)
    mask = np.ones((2, c, l), bool)
    mask[:, 3, 1] = False
    ang = np.concatenate([rng.uniform(-0.2, 0.2, (2, c // 2)),
                          rng.uniform(0.7, 0.78, (2, c - c // 2))], axis=1)
    align = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    scene_tr = np.array([[0.0, 0.0], [3.5, -2.25]], np.float32)
    fs = np.full((2, 2), float(q), np.float32)
    return (dt3, jfm.make_angles(depth), scene_tr, fs, cand, mask, align)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("version", [2, 3, 4])
def test_optimize_kernel_matches_jax(optimize_inputs, entry_calls, monkeypatch,
                                     version, mode):
    monkeypatch.setattr(wk, "INTERPRET", True)
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL", "1")
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    jax.clear_caches()          # the JAX package reads the version at trace time
    xs, xt, xv = (np.asarray(a) for a in jok.optimize_candidates_batch_kernel(
        *map(jnp.asarray, optimize_inputs), mode=mode, window=MODES[mode]))
    before = topt.host_sync.count
    ks, kt, kv = (a.numpy() for a in tok.optimize_candidates_batch_kernel(
        *map(torch.as_tensor, optimize_inputs), mode=mode, window=MODES[mode]))
    assert topt.host_sync.count - before > 4            # stragglers walked
    assert set(entry_calls) == ({version} - {4})
    np.testing.assert_array_equal(kv, xv)
    assert np.abs(xt[0][xv[0]]).max() > 100, "walks did not leave the window"
    np.testing.assert_array_equal(kt[kv], xt[xv])
    if version == 4:    # K1 sums lines in line order, the TPU's v4 by slice
        np.testing.assert_allclose(ks[kv], xs[xv], rtol=3e-7)
    else:
        np.testing.assert_array_equal(ks[kv], xs[xv])
    if mode == "indulgent":     # the case tells the two greedy modes apart
        ds, dt, _ = (a.numpy() for a in tok.optimize_candidates_batch_kernel(
            *map(torch.as_tensor, optimize_inputs), mode="default", window=32))
        assert ((ds != ks) | (dt != kt).any(-1))[kv].any()


@pytest.mark.parametrize("mode", list(MODES))
def test_v3_quarantined_candidate_scores_exactly(entry_calls, monkeypatch,
                                                 mode):
    """Generation 3 quarantines candidate 0 (its identity column misses the
    reference's double-rounded one at step 11: tc = 0, weight 0 on every
    line, a main-pass window of zeros).  Its aligned score and its walks
    come from K1, so every candidate's result equals generation 4's; the
    JAX package would take the zero lane as a perfect aligned score."""
    ex, trx = np.float32(193.0952), np.float32(30.90479)
    assert np.trunc(ex + (trx + np.float32(11))) != np.trunc(ex + trx) + 11
    rng = np.random.default_rng(3)
    q, depth = 256, 4
    dt3 = rng.uniform(0, 60, (1, depth, q, q)).astype(np.float32)
    lines = np.array([[[ex, 40.3, ex - 30.7, 70.1], [120.37, 90.2, 150.11, 95.6]],
                      [[60.13, 40.7, 90.29, 70.3], [120.37, 90.2, 150.11, 95.6]],
                      [[70.41, 140.2, 40.57, 100.9], [20.33, 30.1, 25.77, 80.4]]],
                     np.float32)[None]
    inputs = (dt3, jfm.make_angles(depth), np.array([[trx, 5.0]], np.float32),
              np.array([[q, q]], np.float32), lines, np.ones((1, 3, 2), bool),
              np.tile(np.array([1.0, 0.25], np.float32), (1, 3, 1)))
    tcs = []
    main = tok.wk3.window_scores_v3

    def spy(*args, **kw):
        out, tc = main(*args, **kw)
        tcs.append(tc)
        return out, tc
    monkeypatch.setattr(tok.wk3, "window_scores_v3", spy)
    out = {}
    for version in (3, 4):
        monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
        out[version] = [a.numpy() for a in tok.optimize_candidates_batch_kernel(
            *map(torch.as_tensor, inputs), mode=mode, window=MODES[mode])]
    assert tcs[0][0, 0] == 0 and (tcs[0][0, 1:] > 0).all()   # quarantined
    (s3, t3, v3), (s4, t4, v4) = out[3], out[4]
    assert v3.all() and (v3 == v4).all()
    np.testing.assert_array_equal(t3, t4)
    np.testing.assert_allclose(s3, s4, rtol=3e-7)
    assert s3[0, 0] > 1.0


@pytest.fixture(scope="module")
def jax_greedy_runs():
    scenes, templates = _problem()
    lengths = of.get_template_lengths(templates)
    params = of.Dt3Params(4, 5.0, 2.2, of.Distance.L2)
    runs = {}
    for name in ("DefaultOptimize", "IndulgentOptimize"):
        runs[name] = of.match_many(
            scenes, templates, params, of.DefaultSearch(4, 10),
            getattr(of, name)(), penalty=of.ExponentialPenalty(1.5),
            template_lengths=lengths, top_k=TOP_K)
    return scenes, templates, lengths, runs


@pytest.mark.parametrize("optimizer", ["DefaultOptimize", "IndulgentOptimize"])
@pytest.mark.parametrize("version", [2, 3, 4])
def test_match_many_greedy_matches_jax(jax_greedy_runs, entry_calls,
                                       monkeypatch, version, optimizer):
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    scenes, templates, lengths, runs = jax_greedy_runs
    got = ot.match_many(scenes, templates, ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2),
                        ot.DefaultSearch(4, 10), getattr(ot, optimizer)(),
                        penalty=ot.ExponentialPenalty(1.5),
                        template_lengths=lengths, top_k=TOP_K, device="cpu")
    _assert_same_topk(got, runs[optimizer])
    assert set(entry_calls) == ({version} - {4})


@pytest.mark.parametrize("value", ["v3", ""])
def test_unknown_kernel_version_raises(monkeypatch, value):
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", value)
    with pytest.raises(ValueError, match="OPENFDCM_TPU_KERNEL_VERSION"):
        tok.kernel_version()
    scenes, templates = _problem()
    with pytest.raises(ValueError, match="OPENFDCM_TPU_KERNEL_VERSION"):
        ot.match_many(scenes[:1], templates, ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2),
                      ot.DefaultSearch(3, 4), ot.DefaultOptimize(), top_k=3,
                      device="cpu")


@pytest.mark.parametrize("value", ["5", "1"])
def test_other_integer_kernel_version_is_generation_2(monkeypatch, entry_calls,
                                                     value):
    """As in the JAX package, an integer other than 3 or 4 selects
    generation 2."""
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", value)
    assert tok.kernel_version() == 2
    scenes, templates = _problem()
    got = ot.match_many(scenes[:1], templates, ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2),
                        ot.DefaultSearch(3, 4), ot.DefaultOptimize(), top_k=3,
                        device="cpu")
    assert len(got) == 1 and got[0]
    assert set(entry_calls) == {2}


def test_kernel_version_default(monkeypatch):
    monkeypatch.delenv("OPENFDCM_TPU_KERNEL_VERSION", raising=False)
    assert tok.kernel_version() == 4
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", "3")
    assert tok.kernel_version() == 3
