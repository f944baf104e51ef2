"""Kernels K5 and K6 (window generations 2 and 3): their plain versions
against the JAX package's Pallas kernels, run in the Pallas interpreter on
the CPU as ``tests/test_window_kernel.py`` runs them.

Bar: bit-equal on every lane (covered or not) of the two-sided main pass
and the one-sided extension pass, ``tc`` and ``cover`` bit-equal, the v3
quarantine identical.  One exception, named: XLA:CPU contracts the Pallas
kernels' ``trn + m*vy`` into an FMA, which the TPU does not, and the port
does not (every product rounds, as in kernel K1).  A lane whose probe row
moves under that contraction differs; ``test_interpreter_fma_lane`` pins
one such lane per generation, and the lane-wise tests exclude candidates
with any such probe (none in their seeded inputs).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openfdcm_tpu.core import rasterize as jras
from openfdcm_tpu.ops import window_kernel as wk
from openfdcm_tpu_torch.ops import window_v2 as tw2
from openfdcm_tpu_torch.ops import window_v3 as tw3

torch.set_num_threads(1)

JAX_ENTRY = {2: (wk.window_scores, wk.window_scores_ext),
             3: (wk.window_scores_v3, wk.window_scores_ext_v3)}
PORT_ENTRY = {2: (tw2.window_scores_v2, tw2.window_scores_v2_ext),
              3: (tw3.window_scores_v3, tw3.window_scores_v3_ext)}


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(wk, "INTERPRET", True)
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL", "1")


def _fma_sensitive(lines, mask, rast, tr, t0, steps=200):
    """Per candidate: does any used probe row ``trunc(e_min + (trn +
    m*vy))`` change when the product and sum are fused, for a step ``m`` in
    ``t0 +- steps``?  ``lines (M, L, 4)``, ``rast``/``tr (M, 2)``,
    ``t0 (M,)``."""
    f32 = np.float32
    xm = np.abs(rast[:, 0]) >= np.abs(rast[:, 1])
    vy = np.where(xm, rast[:, 1], rast[:, 0]).astype(f32)[:, None, None]
    trn = np.where(xm, tr[:, 1], tr[:, 0]).astype(f32)[:, None, None]
    e_min = np.where(xm[:, None, None], lines[..., 1::2], lines[..., 0::2])
    m = (t0[:, None] + np.arange(-steps, steps + 1)).astype(f32)[:, None, :]
    e = e_min.reshape(len(lines), -1)[..., None]                # (M, 2L, 1)
    with np.errstate(invalid="ignore"):
        unfused = np.trunc(e + (trn + m * vy))
        fused = np.trunc(e + (trn.astype(np.float64) + m.astype(np.float64)
                              * vy.astype(np.float64)).astype(f32))
    used = np.repeat(mask, 2, axis=1)[..., None]
    return ((unfused != fused) & used & np.isfinite(e)).any(axis=(1, 2))


def _case(seed, s=2, c=13, l=5, d=5, q=256):
    """Lines anywhere on the canvas and a little beyond (patch and chunk
    clamps at both edges, negative columns), both majors, masked lines,
    invalid candidates; ``c`` not a multiple of 8."""
    rng = np.random.default_rng(seed)
    scene_tr = rng.uniform(10, 30, (s, 2)).astype(np.float32)
    center = rng.uniform(-0.05 * q, 1.05 * q, (s, c, l, 2)).astype(np.float32)
    delta = rng.uniform(-8, 8, (s, c, l, 2)).astype(np.float32)
    lines = (np.concatenate([center - delta, center + delta], axis=-1)
             - np.concatenate([scene_tr, scene_tr], axis=-1)[:, None, None, :])
    ang = rng.uniform(0, 2 * np.pi, (s, c)).astype(np.float32)
    align = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    m = s * c
    b = 11
    return dict(
        dt3=rng.uniform(0, 100, (s, d, q, q)).astype(np.float32),
        scene_tr=scene_tr, lines=lines.astype(np.float32),
        mask=rng.uniform(size=(s, c, l)) < 0.8,
        rast=np.array(jras.rasterize_vector(jnp.asarray(align))),
        valid=rng.uniform(size=(s, c)) < 0.9,
        slice_idx=rng.integers(0, d, (s, c, l)).astype(np.int32),
        sel=rng.choice(m, b, replace=False),
        sign=rng.choice([-1.0, 1.0], b).astype(np.float32),
        active=rng.uniform(size=b) < 0.8,
        t0=rng.integers(1, 40, b).astype(np.float32))


@pytest.mark.parametrize("version", [2, 3])
def test_plain_matches_jax_every_lane(interpret_kernel, version):
    k = _case(version)
    s, c, l = k["mask"].shape
    m = s * c
    jmain, jext = JAX_ENTRY[version]
    pmain, pext = PORT_ENTRY[version]
    main_args = (k["dt3"], k["scene_tr"], k["lines"], k["mask"], k["rast"],
                 k["valid"], k["slice_idx"])
    want, want_tc = jmain(*map(jnp.asarray, main_args))
    got, got_tc = pmain(*map(torch.as_tensor, main_args))
    np.testing.assert_array_equal(got_tc.numpy(), np.asarray(want_tc))
    assert got_tc.dtype == torch.int32

    flat = lambda a, *shape: a.reshape(m, *shape)
    scene_of = np.repeat(np.arange(s), c)
    sens = _fma_sensitive(flat(k["lines"], l, 4), flat(k["mask"], l),
                          flat(k["rast"], 2), k["scene_tr"][scene_of],
                          np.zeros(m, np.float32))
    assert sens.sum() == 0
    np.testing.assert_array_equal(flat(got.numpy(), -1)[~sens],
                                  flat(np.asarray(want), -1)[~sens])
    # steep candidates get a small tc: lanes beyond it are compared too
    assert (np.asarray(want_tc)[k["valid"]] < 20).any()

    sel = k["sel"]
    vdir = (k["sign"][:, None] * flat(k["rast"], 2)[sel]).astype(np.float32)
    ext_args = (flat(k["lines"], l, 4)[sel], flat(k["mask"], l)[sel], vdir,
                k["active"], flat(k["slice_idx"], l)[sel],
                scene_of[sel].astype(np.int32), k["scene_tr"], k["t0"])
    jstack = jnp.asarray(k["dt3"])
    jbanks = (jstack, jnp.swapaxes(jstack, -1, -2)) if version == 2 \
        else (wk.prep_dt3_banks(jstack),)
    want_x, want_cover = jext(*jbanks, *map(jnp.asarray, ext_args))
    got_x, got_cover = pext(torch.as_tensor(k["dt3"]),
                            *map(torch.as_tensor, ext_args))
    np.testing.assert_array_equal(got_cover.numpy(), np.asarray(want_cover))
    sens = _fma_sensitive(ext_args[0], ext_args[1], vdir,
                          k["scene_tr"][scene_of[sel]], k["t0"])
    assert sens.sum() == 0
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    assert got_x.shape == (len(sel), 64)


# (trn, vy, e_min, lane): found by a scan, trunc(e + (trn + m*vy)) and
# trunc(e + fma(m, vy, trn)) differ by one row at the lane's step m
FMA_CASES = {2: (28.44939, -0.11050378, 117.85478, 48),
             3: (26.002756, 0.10513883, 179.10474, 18)}


@pytest.mark.parametrize("version", [2, 3])
def test_interpreter_fma_lane(interpret_kernel, version):
    """The interpreter reads the FMA row on exactly one lane, inside the
    covered window; the port reads the rounded-product row there, as the
    TPU does.  Every other lane is bit-equal."""
    f32 = np.float32
    trn, vy, en = map(f32, FMA_CASES[version][:3])
    lane = FMA_CASES[version][3]
    rng = np.random.default_rng(0)
    dt3 = rng.uniform(0, 100, (1, 2, 256, 256)).astype(f32)
    args = (dt3, np.array([[20.0, trn]], f32),
            np.array([[[[100.0, en, 140.0, en - 3.0]]]], f32),
            np.ones((1, 1, 1), bool), np.array([[[1.0, vy]]], f32),
            np.ones((1, 1), bool), np.zeros((1, 1, 1), np.int32))
    want, tc = JAX_ENTRY[version][0](*map(jnp.asarray, args))
    got, _ = PORT_ENTRY[version][0](*map(torch.as_tensor, args))
    want, got = np.asarray(want)[0, 0], got.numpy()[0, 0]
    m = f32(lane)
    assert m <= int(np.asarray(tc)[0, 0])                 # a covered lane

    def value(fused):
        def row(e):
            t = f32(np.float64(trn) + np.float64(m) * np.float64(vy)) if fused \
                else trn + m * vy
            return int(np.trunc(f32(e + t)))
        col = lambda x: int(np.trunc(f32(x + f32(20.0 + m))))
        return abs(dt3[0, 0, row(f32(en - 3.0)), col(f32(140.0))]
                   - dt3[0, 0, row(en), col(f32(100.0))])

    assert value(True) != value(False)
    assert want[lane] == value(True) and got[lane] == value(False)
    others = np.arange(128) != lane
    np.testing.assert_array_equal(got[others], want[others])


def test_v3_quarantine_matches_jax():
    """The scanned pair of ``tests/test_window_kernel.py``: the identity
    column misses the reference's double-rounded one at step 1, so the
    candidate is quarantined in the main pass and in an extension pass
    that covers step 1; a clean candidate keeps its coverage."""
    ex, trx = np.float32(478.9451599), np.float32(33.05481339)
    e_maj = np.asarray([[[[ex, ex - 3.0], [10.0, 12.0]]]], np.float32)
    args = (e_maj, np.asarray([[trx]], np.float32),
            np.asarray([[1.0]], np.float32), np.asarray([[10.0]], np.float32))
    want = np.asarray(wk._identity_deviance(*map(jnp.asarray, args)))
    got = tw3.identity_deviance(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] and not got[0, 0, 1]

    dt3 = np.random.default_rng(1).uniform(0, 50, (1, 4, 512, 512)).astype(np.float32)
    scene_tr = np.asarray([[trx, 5.0]], np.float32)
    mask, valid = np.ones((1, 2, 2), bool), np.ones((1, 2), bool)
    lines = np.asarray([[[[ex, 40.0, ex + 5.0, 42.0], [30.0, 60.0, 44.0, 61.0]],
                         [[100.0, 40.0, 105.0, 42.0], [30.0, 60.0, 44.0, 61.0]]]],
                       np.float32)
    rast = np.asarray([[[1.0, 0.25], [1.0, 0.25]]], np.float32)
    slice_idx = np.zeros((1, 2, 2), np.int32)
    _, want_tc = wk.build_fields_v3(*map(jnp.asarray, (lines, mask, rast, valid,
                                                       slice_idx, scene_tr)),
                                    depth=4, q=512)
    out, tc = tw3.window_scores_v3(*map(torch.as_tensor, (dt3, scene_tr, lines, mask,
                                                          rast, valid, slice_idx)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(want_tc))
    assert tc[0, 0] == 0 and tc[0, 1] > 0
    assert (out[0, 0] == 0).all() and (out[0, 1] > 0).any()

    ext = (lines[0], mask[0], rast[0], np.ones(2, bool), slice_idx[0],
           np.zeros(2, np.int32), scene_tr, np.ones(2, np.float32))
    _, want_cover = wk.build_fields_ext_v3(*map(jnp.asarray, ext), depth=4, q=512)
    scores, cover = tw3.window_scores_v3_ext(torch.as_tensor(dt3),
                                             *map(torch.as_tensor, ext))
    np.testing.assert_array_equal(cover.numpy(), np.asarray(want_cover))
    assert cover[0] == 0 and cover[1] > 0 and (scores[0] == 0).all()


@pytest.mark.parametrize("version,q", [(2, 128), (2, 200), (3, 320)])
def test_canvas_the_generation_cannot_serve_raises(version, q):
    args = (torch.zeros(1, 2, q, q), torch.zeros(1, 2), torch.zeros(1, 1, 1, 4),
            torch.ones(1, 1, 1, dtype=torch.bool), torch.ones(1, 1, 2),
            torch.ones(1, 1, dtype=torch.bool),
            torch.zeros(1, 1, 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="canvas"):
        PORT_ENTRY[version][0](*args)
