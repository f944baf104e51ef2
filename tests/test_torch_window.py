"""Kernel K1's plain version and the port's BatchOptimize walks against the
JAX package on the CPU.

Bars: per-lane window scores bit-equal with one line; relative error at
most 3e-7 with many lines (XLA's sum order is not the line order — the
bound the JAX package holds its own kernel to); chain decisions and walk
results ``(best, mul)`` equal, including walks forced far beyond the
covered window and a tiny coverage ``TC``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openfdcm_tpu.core import rasterize as jras
from openfdcm_tpu.matching import featuremap as jfm
from openfdcm_tpu.matching import optimize as jopt
from openfdcm_tpu.matching import optimize_kernel as jok
from openfdcm_tpu_torch.core import rasterize as tras
from openfdcm_tpu_torch.matching import optimize as tokopt
from openfdcm_tpu_torch.matching import optimize_kernel as tok
from openfdcm_tpu_torch.ops import window as tw

torch.set_num_threads(1)


def _window_case(seed, n_lines, s=2, c=24, d=6, q=128):
    rng = np.random.default_rng(seed)
    li = rng.uniform(0, 500, (s, d, q, q)).astype(np.float32)
    scene_tr = rng.uniform(5, 25, (s, 2)).astype(np.float32)
    center = rng.uniform(q * 0.3, q * 0.7, (s, c, n_lines, 2)).astype(np.float32)
    delta = rng.uniform(-9, 9, (s, c, n_lines, 2)).astype(np.float32)
    lines = (np.concatenate([center - delta, center + delta], axis=-1)
             - np.concatenate([scene_tr, scene_tr], axis=-1)[:, None, None, :])
    mask = rng.uniform(size=(s, c, n_lines)) < 0.8
    mask[..., 0] = True
    ang = rng.uniform(0, 2 * np.pi, (s, c)).astype(np.float32)
    align = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    rast = np.asarray(jras.rasterize_vector(jnp.asarray(align)))
    slc = rng.integers(0, d, (s, c, n_lines))
    t0 = rng.integers(0, 30, (s, c)).astype(np.float32)
    m = s * c
    scene_of = np.repeat(np.arange(s), c)
    sid = (slc.reshape(m, n_lines) + scene_of[:, None] * d).astype(np.int32)
    return dict(li=li, lines=lines.reshape(m, n_lines, 4).astype(np.float32),
                mask=mask.reshape(m, n_lines), rast=rast.reshape(m, 2),
                sid=sid, tr=np.repeat(scene_tr, c, axis=0), t0=t0.reshape(m),
                q=q)


def _jax_window(case, t0, sign, count):
    m, n_lines = case["mask"].shape
    return np.asarray(jopt._window_scores(
        jnp.asarray(case["li"]).reshape(-1), (case["q"], case["q"]),
        jnp.asarray(case["sid"]), jnp.asarray(case["lines"]).reshape(m, n_lines, 2, 2),
        jnp.asarray(case["mask"].astype(np.float32)),
        jnp.asarray(case["tr"])[:, None, :], jnp.asarray(case["rast"]),
        jnp.asarray(t0), sign, count))


def _port_window(case, t0, v, count, two_sided):
    t = lambda a, dt=None: torch.as_tensor(np.array(a, dt))
    return tw.window_scores(t(case["li"]), t(case["lines"]), t(case["sid"]),
                            t(case["mask"], np.float32), t(case["tr"]),
                            t(v, np.float32), t(t0, np.float32), count=count,
                            two_sided=two_sided).numpy()


@pytest.mark.parametrize("n_lines", [1, 9])
def test_window_plain_matches_jax(n_lines):
    case = _window_case(0, n_lines)
    rast, t0 = case["rast"], case["t0"]
    zero = np.zeros_like(t0)
    # two-sided main pass: lanes 0..63 are m = 0..63, lanes 64..127 m = -1..-64
    got2 = _port_window(case, zero, rast, tw.K_LANES, True)
    want2 = np.concatenate([_jax_window(case, zero, 1.0, 64),
                            _jax_window(case, zero + 1, -1.0, 64)], axis=1)
    # one-sided, negative direction from per-candidate resume steps
    got1 = _port_window(case, t0, -rast, 40, False)
    want1 = _jax_window(case, t0, -1.0, 40)
    for got, want in ((got2, want2), (got1, want1)):
        if n_lines == 1:
            np.testing.assert_array_equal(got, want)
        else:
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
            assert rel.max() <= 3e-7, rel.max()


def _chain_case(seed, m=48, h=60, tcov_small=False):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 30, (m, h)).astype(np.float32)
    scores[::3] = np.sort(scores[::3], axis=1)[:, ::-1]      # long descents
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
def test_batch_chain_cov_matches_jax(tcov_small, sign):
    scores, t_lim, tcov, state = _chain_case(1, tcov_small=tcov_small)
    want = jok._batch_chain_cov(jnp.asarray(scores), jnp.asarray(t_lim),
                                jnp.asarray(tcov),
                                tuple(jnp.asarray(x) for x in state), sign, 10)
    got = tok._batch_chain_cov(torch.as_tensor(scores), torch.as_tensor(t_lim),
                               torch.as_tensor(tcov),
                               tuple(torch.as_tensor(x) for x in state), sign, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def straggler_case():
    """The DT3 decreases along +x, so x-major walks keep descending to their
    translation limit (hundreds of steps: extension passes and lockstep
    walks); steep rays cover fewer columns per step (mirrors
    ``tests/test_window_kernel.py::test_v4_forced_stragglers_512``)."""
    depth, q = 8, 256
    rng = np.random.default_rng(11)
    base = (np.arange(q, dtype=np.float32)[::-1] * 3.0)[None, None, :]
    dt3 = np.broadcast_to(base, (depth, q, q)).copy()
    dt3 += rng.uniform(0, 0.5, (depth, q, q)).astype(np.float32)
    dt3 = np.cumsum(dt3, axis=2, dtype=np.float32)[None]
    c, l = 24, 4
    p1 = rng.uniform(40, 120, (c, l, 2)).astype(np.float32)
    d = rng.uniform(-12, 12, (c, l, 2)).astype(np.float32)
    cand = np.concatenate([p1, p1 + d], axis=-1)[None]
    mask = np.ones((1, c, l), bool)
    ang = np.concatenate([rng.uniform(-0.2, 0.2, c // 2),
                          rng.uniform(0.7, 0.78, c - c // 2)]).astype(np.float32)
    align = np.stack([np.cos(ang), np.sin(ang)], axis=-1)[None]
    scene_tr = np.zeros((1, 2), np.float32)
    fs = np.asarray([[float(q), float(q)]], np.float32)
    angles = jfm.make_angles(depth)
    xs, xt, xv = jopt.optimize_candidates(
        jnp.asarray(dt3).reshape(-1), jnp.asarray(angles),
        jnp.asarray(scene_tr[0]), (q, q), jnp.asarray(fs[0]),
        jnp.asarray(cand[0]), jnp.asarray(mask[0]), jnp.asarray(align[0]),
        mode="batch", window=10, dense_steps=0)
    inputs = tuple(torch.as_tensor(a) for a in
                   (dt3, angles, scene_tr, fs, cand, mask, align))
    return inputs, (np.asarray(xs), np.asarray(xt), np.asarray(xv))


@pytest.mark.parametrize("tc", [63, 7])
def test_forced_stragglers_match_jax(straggler_case, monkeypatch, tc):
    """Walks that leave the covered window finish exactly, and the result
    does not depend on the coverage ``TC``."""
    monkeypatch.setattr(tok, "TC", tc)
    inputs, (xs, xt, xv) = straggler_case
    ks, kt, kv = tok.optimize_candidates_batch_kernel(*inputs, mode="batch",
                                                      window=10)
    ks, kt, kv = ks.numpy()[0], kt.numpy()[0], kv.numpy()[0]
    np.testing.assert_array_equal(kv, xv)
    assert np.abs(xt[xv]).max() > 100, "walks did not leave the covered window"
    np.testing.assert_allclose(ks[kv], xs[kv], rtol=3e-7)
    np.testing.assert_array_equal(kt[kv], xt[kv])


def test_rasterize_vector_bit_equal():
    rng = np.random.default_rng(4)
    v = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    v[:4] = [[0, 1], [1, 0], [-1, 0], [0, 0]]
    want = np.asarray(jras.rasterize_vector(jnp.asarray(v)))
    got = tras.rasterize_vector(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_batch_walk_matches_jax(sign):
    """The lockstep walk backstop on the same score table: each call of
    ``eval_window(t0)`` returns ``table[c, t0 + i]``, ``i < batch``."""
    rng = np.random.default_rng(6)
    m, t_max, batch = 40, 200, 10
    table = np.cumsum(rng.uniform(-1.0, 0.6, (m, t_max)), axis=1).astype(np.float32)
    t_lim = rng.integers(5, 150, m).astype(np.float32)
    prev = rng.uniform(-5, 5, m).astype(np.float32)
    done = rng.uniform(size=m) < 0.15
    t0 = rng.integers(1, 30, m).astype(np.float32)
    state = (prev, prev.copy(), np.zeros(m, np.float32), done, t0)
    idx = np.arange(batch)

    def jax_eval(t):
        cols = jnp.clip(t.astype(jnp.int32)[:, None] + idx[None, :], 0, t_max - 1)
        return jnp.take_along_axis(jnp.asarray(table), cols, axis=1)

    def port_eval(t):
        cols = (t.to(torch.int64)[:, None] + torch.as_tensor(idx)[None, :]).clamp(0, t_max - 1)
        return torch.gather(torch.as_tensor(table), 1, cols)

    want = jopt._batch_walk(jax_eval, jnp.asarray(t_lim),
                            tuple(jnp.asarray(x) for x in state), sign, batch)
    got = tokopt._batch_walk(port_eval, torch.as_tensor(t_lim),
                             tuple(torch.as_tensor(x) for x in state), sign, batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
