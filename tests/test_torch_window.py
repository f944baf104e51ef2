"""Kernel K1's plain version and the port's BatchOptimize walks against the
JAX package on the CPU.

Bars: per-lane window scores bit-equal with one line; relative error at
most 3e-7 with many lines (XLA's sum order is not the line order — the
bound the JAX package holds its own kernel to); chain decisions and walk
results ``(best, mul)`` equal, including walks forced far beyond the
covered window and a tiny coverage ``TC``.  A Python mirror of the CUDA
kernel's probe arithmetic (``csrc/window.cu``: the 32-bit in-slice index,
its exact 64-bit fallback, the tiled copy) is held bit-equal to the plain
version and, as above, to the JAX package.
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
from openfdcm_tpu_torch.matching import pipeline as tpipe
from openfdcm_tpu_torch.ops import window as tw
from tests.test_torch_gpu import _rasterized_case

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


# --- mirror of csrc/window.cu ---------------------------------------------

K_GROUP = 4          # window.cu kGroup: lines whose probes are in flight together


def trunc_u(p: np.ndarray) -> np.ndarray:
    """``trunc_u``: the bits of ``p + 2^23`` rounded toward zero to f32,
    minus those of ``2^23``, as uint32."""
    p = np.asarray(p, np.float32)
    s64 = p.astype(np.float64) + 2.0 ** 23       # exact unless |p| < 2^-29
    with np.errstate(over="ignore", invalid="ignore"):
        r = s64.astype(np.float32)
        over = np.abs(r.astype(np.float64)) > np.abs(s64)
    r = np.where(over, np.nextafter(r, np.float32(0)), r)
    # a tiny negative p: the f64 sum rounded up to 2^23, the exact one is below
    r = np.where((p < 0) & (s64 >= 2.0 ** 23), np.nextafter(np.float32(2 ** 23),
                                                           np.float32(0)), r)
    return r.astype(np.float32).view(np.uint32) - np.uint32(0x4B000000)


def trunc64(p: np.ndarray) -> np.ndarray:
    """``trunc64``: clamp to +-2^24 (NaN to the low end), truncate."""
    p = np.nan_to_num(np.asarray(p, np.float32), nan=-2.0 ** 24)
    return np.trunc(np.clip(p, -2.0 ** 24, 2.0 ** 24)).astype(np.int64)


def tile_offset(x, y, tw_):
    """``slice_offset<kTiles>``: 8 x 4 tiles of four 4 x 2 sectors."""
    x, y = np.asarray(x, np.int64), np.asarray(y, np.int64)
    return (((y >> 2) * tw_ + (x >> 3)) * 32 + ((y >> 1) & 1) * 16
            + ((x >> 2) & 1) * 8 + (y & 1) * 4 + (x & 3))


def k1_mirror(li, ep, sid, wt, tr, v, t0, *, count, two_sided, tiles=None,
              paths=None):
    """``window_kernel<kRows>`` (``tiles`` None) or ``<kTiles>`` on host
    arrays: per warp of 32 lanes (idle lanes repeat the last) and per group
    of ``K_GROUP`` lines of nonzero weight (staged 32 lines at a time), the
    32-bit in-slice offsets when every probe of the group lies inside its
    slice, else the exact flat index, clamped, then moved to the layout.
    ``paths``: optional dict counting the groups that took each path."""
    s_, d_, h, w = li.shape
    hw, n_slices = h * w, s_ * d_
    length = li.size
    src = li.reshape(-1) if tiles is None else tiles.reshape(-1)
    th, tw_ = -(-h // 4), -(-w // 8)
    slice_len = hw if tiles is None else th * tw_ * 32
    f32 = np.float32
    m_count, n_lines = wt.shape
    out = np.zeros((m_count, count), f32)
    for c in range(m_count):
        for ch in range(-(-count // 32)):
            k_out = ch * 32 + np.arange(32)
            k = np.minimum(k_out, count - 1)
            step = np.where(two_sided & (k >= 64), -(k - 63), k).astype(f32)
            m = f32(t0[c]) + step
            trx = f32(tr[c, 0]) + m * f32(v[c, 0])
            try_ = f32(tr[c, 1]) + m * f32(v[c, 1])
            acc = np.zeros(32, f32)
            for l0 in range(0, n_lines, 32):
                live = [j for j in range(l0, min(l0 + 32, n_lines)) if wt[c, j] != 0]
                for g in range(0, len(live), K_GROUP):
                    group = live[g:g + K_GROUP]
                    probes = [(ep[c, j, 0] + trx, ep[c, j, 1] + try_,
                               ep[c, j, 2] + trx, ep[c, j, 3] + try_) for j in group]
                    inside = all(
                        0 <= sid[c, j] < n_slices and (trunc_u(px) < w).all()
                        and (trunc_u(py) < h).all()
                        for j, pr in zip(group, probes)
                        for px, py in (pr[:2], pr[2:]))
                    if paths is not None:
                        key = "inside" if inside else "exact"
                        paths[key] = paths.get(key, 0) + 1
                    vals = []
                    for j, pr in zip(group, probes):
                        base = np.int64(sid[c, j]) * slice_len
                        for px, py in (pr[:2], pr[2:]):
                            if inside:
                                x, y = trunc_u(px), trunc_u(py)
                                off = (y.astype(np.int64) * w + x if tiles is None
                                       else tile_offset(x, y, tw_))
                                vals.append(src[base + off])
                                continue
                            flat = np.int64(sid[c, j]) * hw + trunc64(py) * w + trunc64(px)
                            flat = np.clip(flat, 0, length - 1)
                            if tiles is not None:
                                q, r = np.divmod(flat, hw)
                                flat = q * slice_len + tile_offset(r % w, r // w, tw_)
                            vals.append(src[flat])
                    for i, j in enumerate(group):
                        d = np.abs(vals[2 * i] - vals[2 * i + 1])
                        acc = acc + d * f32(wt[c, j])
            keep = k_out < count
            out[c, k_out[keep]] = acc[keep]
    return out


def test_trunc_u_mirror():
    """``trunc_u(p) < W`` holds exactly when ``0 <= p < W``, and then gives
    ``trunc(p)``: NaN, infinities, negatives (tiny ones too), values at and
    beyond 2^23 fall outside."""
    rng = np.random.default_rng(0)
    p = np.concatenate([
        rng.uniform(-700, 700, 20000), rng.uniform(-1, 1, 2000),
        [0.0, -0.0, 1e-30, -1e-30, -1e-45, 0.999999, 639.99994, 640.0,
         2.0 ** 23 - 1, 2.0 ** 23, 2.0 ** 24, -2.0 ** 23, -2.0 ** 31, 3e38,
         -3e38, np.inf, -np.inf, np.nan]]).astype(np.float32)
    u = trunc_u(p)
    for w in (1, 57, 640, 2 ** 23 - 1):
        inside = (p >= 0) & (p < w)
        np.testing.assert_array_equal(u < w, inside)
        np.testing.assert_array_equal(u[inside], np.trunc(p[inside]).astype(np.uint32))


@pytest.mark.parametrize("shape", [(1, 2, 8, 16), (2, 3, 42, 57), (1, 1, 5, 3)])
def test_tile_kernel_index_mirror(shape):
    """``tile_kernel``'s map (one thread per 16 output bytes: tile ``o //
    8``, quad ``j = o % 8`` holding row ``2 (j // 4) + j % 2`` and columns
    ``4 (j // 2 % 2) ..`` of its tile, 0 beyond the canvas) and
    ``slice_offset<kTiles>`` against the plain tiled copy."""
    li = np.random.default_rng(1).uniform(0, 9, shape).astype(np.float32)
    n, th, tw_, _ = tw.tile_shape(shape)
    h, w = shape[-2:]
    flat = li.reshape(n, h, w)
    o = np.arange(n * th * tw_ * 8)
    t, j = o >> 3, o & 7
    q, r = np.divmod(t, th * tw_)
    ty, tx = np.divmod(r, tw_)
    y = ty * 4 + ((j >> 2) << 1) + (j & 1)
    x = tx * 8 + (((j >> 1) & 1) << 2)
    got = np.zeros((o.size, 4), np.float32)
    for e in range(4):
        ok = (y < h) & (x + e < w)
        got[ok, e] = flat[q[ok], y[ok], x[ok] + e]
    want = tw.tile_stack(torch.as_tensor(li)).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for qq in range(n):
        np.testing.assert_array_equal(
            want.reshape(-1)[qq * th * tw_ * 32 + tile_offset(xx, yy, tw_)], flat[qq])


@pytest.mark.parametrize("count,two_sided", [(128, True), (64, False), (10, False),
                                             (1, False)])
@pytest.mark.parametrize("tiled", [False, True])
def test_k1_mirror_matches_plain(tiled, count, two_sided):
    """The mirror on rasterized x- and y-major walks of both signs over a
    three-slice stack whose last tile row and column are padding: probes
    that leave the slice at each edge and the stack at both ends, slice ids
    outside the stack, weight-0 lines, every lane pattern, groups on both
    paths; bit-equal to the plain version, which the CPU wrapper runs with
    or without the tiles."""
    li, ep, sid, wt, tr, v, t0 = _rasterized_case(4, (1, 3, 198, 236), 30, 9)
    if two_sided:
        t0 = torch.zeros_like(t0)
    tiles = tw.tile_stack(li) if tiled else None
    want = tw.window_scores_plain(li, ep, sid, wt, tr, v, t0, count=count,
                                  two_sided=two_sided).numpy()
    paths = {}
    got = k1_mirror(*(a.numpy() for a in (li, ep, sid, wt, tr, v, t0)),
                    count=count, two_sided=two_sided,
                    tiles=None if tiles is None else tiles.numpy(), paths=paths)
    assert paths["inside"] > 10 and paths["exact"] > 10, paths
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tw.window_scores(li, ep, sid, wt, tr, v, t0, count=count,
                         two_sided=two_sided, tiles=tiles).numpy(), want)


@pytest.mark.parametrize("n_lines", [1, 12])
def test_k1_mirror_matches_jax(n_lines):
    """The mirror on the tiled copy against the JAX package's window scores
    (two-sided main pass and a one-sided pass), slice ids inside the stack;
    bit-equal with one line, 3e-7 relative with many."""
    li, ep, sid, wt, tr, v, _ = _rasterized_case(5, (2, 3, 48, 48), 32, n_lines)
    sid = sid.clamp(0, 5)
    a = {k: x.numpy() for k, x in dict(li=li, ep=ep, sid=sid, wt=wt, tr=tr, v=v).items()}
    tiles = tw.tile_stack(li).numpy()
    m = wt.shape[0]
    zero = np.zeros(m, np.float32)
    t0 = np.random.default_rng(6).integers(1, 40, m).astype(np.float32)

    def jax(t, sign, count):
        return np.asarray(jopt._window_scores(
            jnp.asarray(a["li"]).reshape(-1), (48, 48), jnp.asarray(a["sid"]),
            jnp.asarray(a["ep"]).reshape(m, n_lines, 2, 2), jnp.asarray(a["wt"]),
            jnp.asarray(a["tr"])[:, None, :], jnp.asarray(a["v"]), jnp.asarray(t),
            sign, count))
    args = (a["li"], a["ep"], a["sid"], a["wt"], a["tr"], a["v"])
    got2 = k1_mirror(*args, zero, count=128, two_sided=True, tiles=tiles)
    want2 = np.concatenate([jax(zero, 1.0, 64), jax(zero + 1, -1.0, 64)], axis=1)
    got1 = k1_mirror(*args, t0, count=10, two_sided=False, tiles=tiles)
    want1 = jax(t0, 1.0, 10)
    for got, want in ((got2, want2), (got1, want1)):
        if n_lines == 1:
            np.testing.assert_array_equal(got, want)
        else:
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
            assert rel.max() <= 3e-7, rel.max()


def test_window_scores_checks_tiles():
    li = torch.zeros((1, 2, 8, 16))
    m = 3
    args = (li, torch.zeros((m, 2, 4)), torch.zeros((m, 2), dtype=torch.int32),
            torch.ones((m, 2)), torch.zeros((m, 2)), torch.zeros((m, 2)),
            torch.zeros(m))
    with pytest.raises(ValueError, match="tiles"):
        tw.window_scores(*args, count=5, two_sided=False,
                         tiles=torch.zeros((2, 2, 3, 32)))
    assert tw.tile_stack(li).shape == tw.tile_shape(li.shape) == (2, 2, 2, 32)


def test_scene_chunk_counts_the_tiled_copy():
    """A dispatch's scenes share the budget with their part of K1's tiled
    stack copy (1 GiB on the CPU)."""
    dev = torch.device("cpu")
    assert tpipe._scene_chunk(1000, 40, 0, dev) == (1 << 30) // (1000 * (8 * 16 * 40 + 4096))
    assert tpipe._scene_chunk(1000, 40, 1 << 29, dev) == 1
