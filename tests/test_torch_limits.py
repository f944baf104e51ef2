"""Calls the JAX package answers beyond the port's kernel limits, through
both packages on the CPU (JAX pinned there by ``tests/conftest.py``):

* K3's relaxation at depths above 96 and with more than 384 steps, which
  the card runs on ``prop_shared`` / ``prop_global``: bit-equal;
* ``match_many`` at depth 100: top-k ids identical, scores within rel 3e-7
  under window generations 4, 2 and 3 (the JAX package's CPU path is its
  generation-free XLA one, which sums a candidate's lines in its own order;
  ROADMAP's bar);
* ``distance_transform`` on canvases with a side of 16,400 px, wide and
  tall, L2 and L2², which the card runs on K2's 64-bit variant: bit-equal;
* ``optimize_candidates`` with the same custom ``take_fn`` (a gather from
  the reversed stack): ``valid`` identical, scores within rel 3e-7,
  translations atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openfdcm_tpu as jof
from openfdcm_tpu.core import dt as jdt
from openfdcm_tpu.matching import featuremap as jfm
from openfdcm_tpu.matching import optimize as jopt
import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.core import dt as tdt
from openfdcm_tpu_torch.matching import featuremap as tfm
from openfdcm_tpu_torch.matching import optimize as topt
from openfdcm_tpu_torch.matching.match import _bucket, _scene_candidates
from openfdcm_tpu_torch.matching.pipeline import _bank_pairs_for_scene
from openfdcm_tpu_torch.ops import minplus as tminplus
from openfdcm_tpu_torch.ops import prop as tprop
from tests.torch_cases import three_scene_problem

torch.set_num_threads(1)

F32_MAX = np.finfo(np.float32).max


def relax_case(depth, n_steps=None, seed=0):
    """A ``(2, depth, 32, 32)`` stack (some cells ``F32_MAX``) and a step
    list: the reference's schedule, or ``n_steps`` random steps."""
    rng = np.random.default_rng([seed, depth])
    dt3 = rng.uniform(0, 40, (2, depth, 32, 32)).astype(np.float32)
    dt3[rng.uniform(size=dt3.shape) < 0.1] = F32_MAX
    if n_steps is None:
        steps = tfm.propagation_steps(tfm.make_angles(depth), 5.0)
    else:
        c = rng.integers(0, depth, (n_steps, 2))
        w = rng.uniform(0, 3, n_steps).astype(np.float32)
        steps = tuple((int(a), int(b), float(x)) for (a, b), x in zip(c, w))
    return dt3, steps


@pytest.mark.parametrize("depth,n_steps,kind", [(97, None, "shared"),
                                                (128, None, "shared"),
                                                (12, 500, "shared")])
def test_relax_beyond_the_kernel_parameter_table(depth, n_steps, kind):
    dt3, steps = relax_case(depth, n_steps)
    assert tprop.variant(depth, len(steps)) == kind
    want = np.asarray(jfm.propagate_orientation_relax(jnp.asarray(dt3), steps))
    got = tfm.propagate_orientation_relax(torch.as_tensor(dt3), steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k3_variant_by_depth_and_steps():
    """The kernel a CUDA stack runs, from ``(depth, steps)`` alone: the
    parameter table up to 96 orientations and 384 steps, then the shared
    memory variant up to 1816 orientations, then the in-place one."""
    assert tprop.variant(96, 384) == "param"
    assert tprop.variant(30, 120) == "param"
    assert tprop.variant(96, 385) == "shared"
    assert tprop.variant(97, 4 * 97) == "shared"
    assert tprop.MAX_SHARED_DEPTH == 1816
    assert tprop.variant(1816, 4 * 1816) == "shared"
    assert tprop.variant(1817, 4 * 1817) == "global"
    dt3, steps = relax_case(1817, 40)
    with pytest.raises(ValueError, match="1816"):
        tprop.propagate_orientation_shared(torch.as_tensor(dt3), steps)
    want = tprop.propagate_orientation_plain(torch.as_tensor(dt3), steps)
    got = tprop.propagate_orientation_global(torch.as_tensor(dt3), steps)
    assert torch.equal(got, want)


DEEP = (100, 5.0, 1.0)


def _deep_problem():
    scenes, templates = three_scene_problem()
    return ([s * np.float32(0.4) for s in scenes[:2]],
            [t * np.float32(0.4) for t in templates])


@pytest.fixture(scope="module")
def deep_jax():
    scenes, templates = _deep_problem()
    return jof.match_many(scenes, templates, jof.Dt3Params(*DEEP, jof.Distance.L2),
                          jof.DefaultSearch(4, 10), jof.DefaultOptimize(),
                          penalty=jof.ExponentialPenalty(1.5), top_k=5,
                          pad_to=128)


@pytest.mark.parametrize("version", [4, 2, 3])
def test_match_many_at_depth_100(deep_jax, version, monkeypatch):
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    scenes, templates = _deep_problem()
    params = ot.Dt3Params(*DEEP, ot.Distance.L2)
    fms = ot.build_featuremap_batch(scenes[:1], params, pad_to=128, device="cpu")
    assert fms.dt3.shape[-3:] == (100, 128, 128)
    got = ot.match_many(scenes, templates, params, ot.DefaultSearch(4, 10),
                        ot.DefaultOptimize(), penalty=ot.ExponentialPenalty(1.5),
                        top_k=5, pad_to=128, device="cpu")
    assert len(got) == len(deep_jax)
    for g_list, w_list in zip(got, deep_jax):
        assert [m.tmpl_idx for m in g_list] == [m.tmpl_idx for m in w_list]
        np.testing.assert_allclose([m.score for m in g_list],
                                   [m.score for m in w_list], rtol=3e-7, atol=0)
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.transform, w.transform, atol=1e-5)


def wide_canvas_lines(size, seed=0):
    """60 short lines spread along the long side of a ``(W, H)`` canvas."""
    rng = np.random.default_rng(seed)
    w, h = size
    along = np.linspace(0, max(w, h), 60)
    across = rng.uniform(0, min(w, h), (60, 2))
    xy = (along, across[:, 0], along + 50, across[:, 1])
    lines = np.stack(xy if w > h else (xy[1], xy[0], xy[3], xy[2]), 1)
    return lines.astype(np.float32)


@pytest.mark.parametrize("metric", ["L2", "L2_SQUARED"])
@pytest.mark.parametrize("size", [(16400, 8), (8, 16400)])
def test_distance_transform_beyond_16384_px(size, metric):
    lines = wide_canvas_lines(size)
    want = np.asarray(jdt.distance_transform(lines, size, getattr(jof.Distance, metric)))
    got = tdt.distance_transform(lines, size, getattr(ot.Distance, metric),
                                 device="cpu")
    assert got.shape == (size[1], size[0])
    assert max(size) > tminplus.MAX_SIDE
    np.testing.assert_array_equal(got.numpy(), want)


def band_scan_reference(g):
    """numpy's L2² row pass of column-pass distances ``g (R, W)``: per
    pixel the least ``fl(fl(g²) + fl(d²))`` over the row's seeded columns,
    each product rounded before the add (as the TPU kernel adds)."""
    out = np.empty(g.shape, np.float32)
    x = np.arange(g.shape[1])
    for r, row in enumerate(g):
        src = np.nonzero(row < F32_MAX)[0]
        d = (x[:, None] - src[None, :]).astype(np.float32)
        out[r] = ((row[src] * row[src])[None, :] + d * d).min(1) \
            if src.size else F32_MAX
    return np.minimum(out, F32_MAX)


def test_row_pass_far_from_every_seed_rounds_each_product():
    """Pixels more than 4096 px from their nearest seed, where ``d²`` is no
    longer an exact f32: the port (on the card K2's 64-bit variant, bit-equal
    to this plain version) rounds ``d²`` before adding ``g²``, as the JAX
    package's TPU kernel does; its CPU path lets XLA fuse ``g² + d * d`` into
    an FMA and lands up to one ulp away (ROADMAP, "Deliberate
    divergences")."""
    size = (16400, 8)
    lines = np.float32([[0, 1, 60, 6], [9000, 2, 9050, 3], [16390, 7, 16399, 0]])
    g = tdt._nearest_1d_l1(tdt.indicator_from_points(
        *tdt.draw.seed_points(torch.as_tensor(lines), 8, 16400, 16500), 8, 16400),
        dim=-2)
    got = tdt.distance_transform(lines, size, ot.Distance.L2_SQUARED, device="cpu")
    np.testing.assert_array_equal(got.numpy(), band_scan_reference(g.numpy()))
    assert float(got.max()) > 4096 ** 2
    want = np.asarray(jdt.distance_transform(lines, size, jof.Distance.L2_SQUARED))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    assert (got.numpy() != want).any()


@pytest.fixture(scope="module")
def take_case():
    """One scene's candidates on its depth-6 stack."""
    scenes, templates = _deep_problem()
    params = jof.Dt3Params(6, 5.0, 1.0, jof.Distance.L2)
    fm = jof.build_featuremap(scenes[0], params, pad_to=64)
    bank = ot.prepare_templates(templates, device="cpu")
    pairs = _bank_pairs_for_scene(ot.DefaultSearch(4, 10), bank, scenes[0])
    lines, mask, align, _, _ = (x.numpy() for x in _scene_candidates(
        bank, pairs, scenes[0], _bucket(pairs.shape[0], 64)))
    w, h = fm.feature_size
    hw = tuple(fm.dt3.shape[1:])
    return dict(dt3_flat=np.array(fm.dt3).reshape(-1), angles=np.array(fm.angles),
                scene_tr=np.array(fm.scene_translation), hw=hw,
                feature_size=np.float32([w, h]), tmpl_lines=lines,
                line_mask=mask, align_vecs=align)


def test_optimize_candidates_take_fn_matches_jax(take_case):
    """A gather from the reversed stack (each clamped flat index ``i``
    reads ``n - 1 - i``) through both packages' ``optimize_candidates``;
    the port's reader gets the JAX layout, ``(2, L, C * K)``."""
    n = take_case["dt3_flat"].size
    kw = dict(mode="batch", window=10, dense_steps=1)
    want = jopt.optimize_candidates(
        *[jnp.asarray(v) if k != "hw" else v for k, v in take_case.items()],
        **kw, take_fn=lambda f, i: jnp.take(f, n - 1 - jnp.clip(i, 0, n - 1)))
    shapes = []

    def reversed_take(f, i):
        shapes.append(tuple(i.shape))
        return f[n - 1 - i.clamp(0, n - 1)]
    args = [torch.as_tensor(v) if k != "hw" else v for k, v in take_case.items()]
    got = topt.optimize_candidates(*args, **kw, take_fn=reversed_take)
    c, l = take_case["line_mask"].shape
    assert shapes and all(s[:2] == (2, l) and s[2] % c == 0 for s in shapes)
    w_s, w_t, w_v = (np.asarray(x) for x in want)
    g_s, g_t, g_v = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_v, w_v)
    assert g_v.sum() > 10
    np.testing.assert_allclose(g_s[g_v], w_s[g_v], rtol=3e-7, atol=0)
    np.testing.assert_allclose(g_t, w_t, rtol=0, atol=1e-5)
    clamped = topt.optimize_candidates(*args, **kw)
    assert not np.array_equal(clamped[0].numpy()[g_v], g_s[g_v])
