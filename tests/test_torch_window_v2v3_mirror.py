"""Python mirrors of kernels K5 and K6 as built (``csrc/window_v2.cu``,
``csrc/window_v3.cu``): one warp of 32 lanes per (candidate, lane chunk),
the candidate's lines staged 32 at a time in ``order`` with the weight-0
ones compacted out (NaN counts as live), 4 lines a group, and per line
either the 32-bit in-slice probe or the exact 64-bit flat index.  K6 stages
each endpoint's lane-independent part (``x0a``, ``off = x0a - c0``, ``y0a``,
``e_min``) and per lane takes the chunk column, its step, the row clamped in
f32 before one truncation, and the column with one conditional subtract
of ``Q`` in place of ``% Q``; K5 stages the patch origins and clamps in f32
the same way.  Both layouts: the row-major stack and K1's tiled copy.

Bars: each mirror bit-equal to its plain version (``window_v2_plain``,
``window_v3_plain``) on every lane, and to the JAX package's Pallas kernels
in the interpreter on every lane of candidates without an interpreter-FMA
probe (the bar of ``tests/test_torch_window_v2v3.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openfdcm_tpu.ops import window_kernel as wk
from openfdcm_tpu_torch.ops import window as tw
from openfdcm_tpu_torch.ops import window_v2 as tw2
from openfdcm_tpu_torch.ops import window_v3 as tw3
from tests.test_torch_gpu import v2v3_case
from tests.test_torch_window import tile_offset, trunc64, trunc_u
from tests.test_torch_window_v2v3 import JAX_ENTRY, _case, _fma_sensitive

torch.set_num_threads(1)

f32 = np.float32
K_GROUP = 4          # kGroup: lines whose probes are in flight together


def _layout(li, tiles):
    """``(flat source, slice length, tiles per row, to_layout)``: the stack
    read and the move of a clamped row-major flat index into it."""
    s_, d_, q, w = li.shape
    if tiles is None:
        return li.reshape(-1), q * w, -(-w // 8), lambda f: f
    tw_ = -(-w // 8)
    slice_len = -(-q // 4) * tw_ * 32

    def to_layout(f):
        qs, r = np.divmod(f, q * w)
        return qs * slice_len + tile_offset(r % w, r // w, tw_)
    return tiles.reshape(-1), slice_len, tw_, to_layout


def _offset(x, y, w, tw_, tiled):
    """``slice_offset``: row-major ``y * w + x``, or the tiled offset."""
    if tiled:
        return tile_offset(x, y, tw_)
    return y.astype(np.int64) * w + x


def _staged(order_c, wt_c):
    """The warp's staging rounds: per 32 lines of ``order``, the lines of
    nonzero weight (NaN counts), compacted in order's order."""
    n_lines = len(order_c)
    return [[int(order_c[j]) for j in range(l0, min(l0 + 32, n_lines))
             if wt_c[order_c[j]] != 0] for l0 in range(0, n_lines, 32)]


def _sum_groups(acc, rounds, probe_pair, wt_c):
    """4 lines' probes per group, then their weighted differences in order."""
    for live in rounds:
        for g in range(0, len(live), K_GROUP):
            group = live[g:g + K_GROUP]
            vals = [probe_pair(l) for l in group]
            for l, (a, b) in zip(group, vals):
                acc = acc + np.abs(b - a) * f32(wt_c[l])
    return acc


def k6_stage_end(em, en, trm, trn, vy, s, m_lo, m_hi, q):
    """``stage_end``: one endpoint's lane-independent ``(x0a, off, y0a as
    f32, e_min)``, in 64-bit integers."""
    c0 = int(trunc64(f32(em) + f32(trm)))
    xa, xb = c0 + s * m_lo, c0 + s * m_hi
    x_lo = min(max(min(xa, xb), 0), q - 1)
    x_hi = min(max(max(xa, xb), 0), q - 1)
    crossing = x_lo // 128 != x_hi // 128
    ls = ((x_lo - 64) // 128) * 128 if crossing else (x_lo // 128) * 128
    ls = min(max(ls, 0), q - 128)
    x0a = ls + (64 if crossing else 0)
    ya = int(trunc64(f32(en) + (f32(trn) + f32(m_lo) * f32(vy))))
    yb = int(trunc64(f32(en) + (f32(trn) + f32(m_hi) * f32(vy))))
    y_lo = min(max(min(ya, yb), 0), q - 1)
    y0a = min(max((y_lo // 8) * 8, 0), q - 32)
    return x0a, x0a - c0, f32(y0a), f32(en), crossing


def k6_probe_xy(e, p_lane, s, trn, vy, xm, q):
    """``probe_xy``: the lanes' pixel ``(x, y)`` of a staged endpoint, in
    32-bit integers: chunk column, its step, the row clamped in f32 and
    truncated, the column wrapped by one conditional subtract."""
    x0a, off, y0a, en = e[:4]
    li = np.clip(p_lane - np.int32(off), 0, 127).astype(np.int32)
    m_col = (s * (np.int32(off) + li)).astype(np.int32)
    p = en + (trn + m_col.astype(f32) * vy)
    row = trunc_u(np.fmin(np.fmax(p, y0a), y0a + f32(31)))
    col = (np.int32(x0a) + li).astype(np.uint32)
    col = np.where(col >= q, col - np.uint32(q), col)
    return (col, row) if xm else (row, col)


def k6_mirror(li, ep, sid, wt, order, geo, t0, tc, x_major, *, two_sided,
              tiles=None, paths=None):
    """``window_v3_kernel<kRows>`` (``tiles`` None) or ``<kTiles>`` on host
    arrays.  ``paths``: optional dict counting staged endpoints whose chunk
    is rolled (``crossing``) and lines that take the exact index."""
    s_, d_, q, _ = li.shape
    n_slices, length = s_ * d_, li.size
    src, slice_len, tw_, to_layout = _layout(li, tiles)
    count = 128 if two_sided else 64
    m_count, n_lines = wt.shape
    out = np.zeros((m_count, count), f32)
    for c in range(m_count):
        vx, vy, trm, trn = (f32(x) for x in geo[c])
        s = -1 if vx < 0 else 1
        t0c = int(trunc64(t0[c]))
        m_lo = t0c - (int(tc[c]) if two_sided else 0)
        m_hi = t0c + int(tc[c])
        xm = x_major[c] != 0
        rounds = _staged(order[c], wt[c])
        staged = {l: tuple(k6_stage_end(ep[c, l, i], ep[c, l, i + 1], trm, trn,
                                        vy, s, m_lo, m_hi, q) for i in (0, 2))
                  for live in rounds for l in live}
        if paths is not None:
            paths["crossing"] = paths.get("crossing", 0) + sum(
                e[4] for ends in staged.values() for e in ends)
        for ch in range(count // 32):
            k = ch * 32 + np.arange(32)
            m_pat = np.where(k >= 64, -(k - 63), k)
            p_lane = (s * (m_pat + t0c)).astype(np.int32)

            def probe_pair(l):
                sl = int(sid[c, l])
                vals = []
                for e in staged[l]:
                    x, y = k6_probe_xy(e, p_lane, s, trn, vy, xm, q)
                    if 0 <= sl < n_slices:
                        idx = sl * slice_len + _offset(x, y, q, tw_, tiles is not None)
                    else:
                        flat = sl * q * q + y.astype(np.int64) * q + x
                        idx = to_layout(np.clip(flat, 0, length - 1))
                        if paths is not None:
                            paths["exact"] = paths.get("exact", 0) + 1
                    vals.append(src[idx])
                return vals
            out[c, k] = _sum_groups(np.zeros(32, f32), rounds, probe_pair, wt[c])
    return out


def k5_mirror(li, ep, org, sid, wt, order, geo, t0, x_major, *, two_sided,
              tiles=None, paths=None):
    """``window_v2_kernel<kRows>`` (``tiles`` None) or ``<kTiles>`` on host
    arrays: staged endpoints and origins; a line whose patches lie inside
    the canvas and whose slice id lies inside the stack clamps in f32 and
    takes the 32-bit in-slice offset, any other the exact 64-bit clamps and
    flat index.  ``paths``: optional dict counting the exact lines."""
    s_, d_, q, _ = li.shape
    n_slices, length = s_ * d_, li.size
    src, slice_len, tw_, to_layout = _layout(li, tiles)
    count = 128 if two_sided else 64
    m_count, n_lines = wt.shape
    out = np.zeros((m_count, count), f32)
    for c in range(m_count):
        vx, vy, trm, trn = (f32(x) for x in geo[c])
        xm = x_major[c] != 0
        rounds = _staged(order[c], wt[c])
        for ch in range(count // 32):
            k = ch * 32 + np.arange(32)
            m = f32(t0[c]) + np.where(k >= 64, -(k - 63), k).astype(f32)
            trx, try_ = trm + m * vx, trn + m * vy

            def probe_pair(l):
                o = [int(x) for x in org[c, l]]
                sl = int(sid[c, l])
                fast = (0 <= sl < n_slices and 0 <= o[0] <= q - 256
                        and 0 <= o[2] <= q - 256 and 0 <= o[1] <= q - 32
                        and 0 <= o[3] <= q - 32)
                if paths is not None and not fast:
                    paths["exact"] = paths.get("exact", 0) + 1
                vals = []
                for i in (0, 2):
                    px, py = f32(ep[c, l, i]) + trx, f32(ep[c, l, i + 1]) + try_
                    ox, oy = o[i], o[i + 1]
                    if fast:
                        maj = trunc_u(np.fmin(np.fmax(px, f32(ox)), f32(ox) + f32(255)))
                        mnr = trunc_u(np.fmin(np.fmax(py, f32(oy)), f32(oy) + f32(31)))
                        x, y = (maj, mnr) if xm else (mnr, maj)
                        vals.append(src[sl * slice_len
                                        + _offset(x, y, q, tw_, tiles is not None)])
                        continue
                    maj = ox + np.clip(trunc64(px) - ox, 0, 255)
                    mnr = oy + np.clip(trunc64(py) - oy, 0, 31)
                    flat = sl * q * q + (mnr * q + maj if xm else maj * q + mnr)
                    vals.append(src[to_layout(np.clip(flat, 0, length - 1))])
                return vals
            out[c, k] = _sum_groups(np.zeros(32, f32), rounds, probe_pair, wt[c])
    return out


MIRROR = {2: (k5_mirror, tw2.window_v2_plain), 3: (k6_mirror, tw3.window_v3_plain)}


def _mirror_on(version, li, args, two_sided, layout, paths=None):
    tiles = tw.tile_stack(li).numpy() if layout == "tiles" else None
    return MIRROR[version][0](li.numpy(), *(a.numpy() for a in args),
                              two_sided=two_sided, tiles=tiles, paths=paths)


@pytest.mark.parametrize("layout", ["tiles", "rows"])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("version,q", [(2, 256), (2, 260), (2, 384), (3, 256),
                                       (3, 384)])
def test_mirror_matches_plain(version, q, two_sided, layout):
    """Both majors, 40 lines per candidate (two staging rounds), a weight-0
    candidate, a NaN weight, slice ids outside the stack and (K5) patches
    beyond the canvas, on the canvases the generations serve (260: a tiled
    copy with a padded tile column); bit-equal to the plain version on every
    lane, NaN where it is NaN."""
    for major in ("x", "y"):
        li, args = v2v3_case(version, two_sided, major, seed=8 + q, c=9,
                             l=40, q=q, edges=True)
        paths = {}
        got = _mirror_on(version, li, args, two_sided, layout, paths)
        want = MIRROR[version][1](li, *args, two_sided=two_sided).numpy()
        assert np.isnan(want).any() and (want == 0).all(axis=1).any()
        assert paths["exact"] > 0, paths
        if version == 3:
            assert paths["crossing"] > 0, paths
        np.testing.assert_array_equal(got, want)


def test_k6_wrap_replaces_the_modulo():
    """Every column a staged endpoint can name, ``x0a + li`` for ``x0a`` in
    ``[0, Q - 64]`` and ``li`` in ``[0, 127]``, lies below ``2Q``, so one
    conditional subtract equals ``% Q``; ``x0a`` takes only those values."""
    for q in (128, 256, 384, 640):
        x0a = np.arange(0, q - 63)[:, None]
        col = (x0a + np.arange(128)[None, :]).astype(np.uint32)
        assert col.max() < 2 * q
        np.testing.assert_array_equal(np.where(col >= q, col - q, col), col % q)
        rng = np.random.default_rng(q)
        for em, t0c, tc in zip(rng.uniform(-300, q + 300, 2000),
                               rng.integers(-80, 80, 2000),
                               rng.integers(0, 63, 2000)):
            for s in (-1, 1):
                x0a_, *_ = k6_stage_end(em, 3.0, 0.5, 1.0, 0.1, s, t0c - tc,
                                        t0c + tc, q)
                assert 0 <= x0a_ <= q - 64


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(wk, "INTERPRET", True)
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL", "1")


@pytest.mark.parametrize("version", [2, 3])
def test_mirror_matches_jax(interpret_kernel, monkeypatch, version):
    """The mirror on the tiled copy, fed the kernel inputs the port's
    entries build, against the JAX package's main and extension passes in
    the Pallas interpreter: every lane bit-equal (no candidate of these
    inputs has an interpreter-FMA probe)."""
    k = _case(version)
    s, c, l = k["mask"].shape
    m = s * c
    mod = tw2 if version == 2 else tw3
    name = "window_v2" if version == 2 else "window_v3"
    calls = []
    real = getattr(mod, name)

    def record(li, *args, two_sided, tiles=None):
        calls.append((li, args, two_sided))
        return real(li, *args, two_sided=two_sided, tiles=tiles)
    monkeypatch.setattr(mod, name, record)

    jmain, jext = JAX_ENTRY[version]
    pmain = tw2.window_scores_v2 if version == 2 else tw3.window_scores_v3
    pext = tw2.window_scores_v2_ext if version == 2 else tw3.window_scores_v3_ext
    main_args = (k["dt3"], k["scene_tr"], k["lines"], k["mask"], k["rast"],
                 k["valid"], k["slice_idx"])
    want, _ = jmain(*map(jnp.asarray, main_args))
    pmain(*map(torch.as_tensor, main_args))

    flat = lambda a, *shape: a.reshape(m, *shape)
    scene_of = np.repeat(np.arange(s), c)
    sel = k["sel"]
    vdir = (k["sign"][:, None] * flat(k["rast"], 2)[sel]).astype(np.float32)
    ext_args = (flat(k["lines"], l, 4)[sel], flat(k["mask"], l)[sel], vdir,
                k["active"], flat(k["slice_idx"], l)[sel],
                scene_of[sel].astype(np.int32), k["scene_tr"], k["t0"])
    jstack = jnp.asarray(k["dt3"])
    jbanks = (jstack, jnp.swapaxes(jstack, -1, -2)) if version == 2 \
        else (wk.prep_dt3_banks(jstack),)
    want_x, _ = jext(*jbanks, *map(jnp.asarray, ext_args))
    pext(torch.as_tensor(k["dt3"]), *map(torch.as_tensor, ext_args))

    assert [two for _, _, two in calls] == [True, False]
    for (li, args, two_sided), ref, sens_args in (
            (calls[0], flat(np.asarray(want), -1),
             (flat(k["lines"], l, 4), flat(k["mask"], l), flat(k["rast"], 2),
              k["scene_tr"][scene_of], np.zeros(m, np.float32))),
            (calls[1], np.asarray(want_x),
             (ext_args[0], ext_args[1], vdir, k["scene_tr"][scene_of[sel]],
              k["t0"]))):
        assert _fma_sensitive(*sens_args).sum() == 0
        got = _mirror_on(version, li, args, two_sided, "tiles")
        np.testing.assert_array_equal(got, ref)
