"""The port's pair generation and candidate geometry against the JAX package
on the CPU.

Bars: ``device_pairs`` windows and ``_make_candidates`` (aligned lines,
transforms, align vectors) bit-equal.  The JAX package launders every
geometry product (``geometry._pmul``) so XLA:CPU cannot fuse it into an
FMA; eager PyTorch rounds every product anyway, which these tests pin.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openfdcm_tpu.core import geometry as jgeo
from openfdcm_tpu.matching import match as jmatch
from openfdcm_tpu.matching import search as jsearch
from openfdcm_tpu_torch.core import geometry as tgeo
from openfdcm_tpu_torch.core.rasterize import fma_f32
from openfdcm_tpu_torch.matching import match as tmatch
from openfdcm_tpu_torch.matching import search as tsearch

torch.set_num_threads(1)


def _bank_and_scenes(seed, n_templates=5, lmax=9, n_scene=40, s=3):
    rng = np.random.default_rng(seed)
    counts = rng.integers(2, lmax + 1, n_templates)
    counts[-1] = 0                                        # an empty template
    lines = np.zeros((n_templates, lmax, 4), np.float32)
    for t, n in enumerate(counts):
        lines[t, :n] = rng.uniform(0, 60, (n, 4))
    lines[0, 1] = lines[0, 0] + [3, 4, 3, 4]              # equal lengths
    mask = np.arange(lmax)[None, :] < counts[:, None]
    d = lines[..., 2:4] - lines[..., 0:2]
    lengths = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2).astype(np.float32)
    scenes = rng.uniform(0, 120, (s, n_scene, 4)).astype(np.float32)
    scenes[:, 5] = scenes[:, 4]                           # length ties
    scenes[:, 6] = [10, 10, 10, 50]                       # vertical
    scenes[:, 7] = [10, 10, 50, 10]                       # horizontal
    n_eff = [n_scene, 25, 0]                              # padded / empty scenes
    return lines, mask, lengths, counts, scenes, n_eff[:s]


@pytest.mark.parametrize("ms", [4, 10])
def test_device_pairs_bit_equal(ms):
    lines, mask, lengths, counts, scenes, n_eff = _bank_and_scenes(0)
    ord_t, k_t = tsearch.bank_line_table(lengths, counts, 4)
    jord, jk = jsearch.bank_line_table(lengths, counts, 4)
    np.testing.assert_array_equal(ord_t, jord)
    lens_m = np.where(np.arange(lengths.shape[1])[None, :] < counts[:, None],
                      lengths, -np.inf)
    top_vals = np.take_along_axis(lens_m, ord_t.astype(np.int64), 1).astype(np.float32)
    rank_ok = np.arange(ord_t.shape[1])[None, :] < k_t[:, None]
    n_pad = 64
    slen = np.zeros((len(n_eff), n_pad), np.float32)
    valid = np.zeros((len(n_eff), n_pad), bool)
    for i, n in enumerate(n_eff):
        slen[i], valid[i] = tsearch.scene_length_mask(scenes[i, :n], n_pad)
        js, jv = jsearch.scene_length_mask(scenes[i, :n], n_pad)
        np.testing.assert_array_equal(slen[i], js)
    got_sl, got_ok = tsearch.device_pairs(torch.as_tensor(slen),
                                          torch.as_tensor(valid),
                                          torch.as_tensor(top_vals),
                                          torch.as_tensor(rank_ok), ms)
    for i in range(len(n_eff)):
        want_sl, want_ok = jsearch.device_pairs(
            jnp.asarray(slen[i]), jnp.asarray(valid[i]), jnp.asarray(top_vals),
            jnp.asarray(rank_ok), ms)
        np.testing.assert_array_equal(got_ok[i].numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(got_sl[i].numpy(), np.asarray(want_sl))
    assert got_ok[0].any() and not got_ok[2].any()


def test_make_candidates_bit_equal():
    lines, mask, lengths, counts, scenes, _ = _bank_and_scenes(1, s=1)
    rng = np.random.default_rng(2)
    p = 300
    pair_t = rng.integers(0, 4, p)
    pair_tl = np.minimum(rng.integers(0, 9, p), counts[pair_t] - 1)
    pair_sl = rng.integers(0, scenes.shape[1], p)
    want = jmatch._make_candidates(
        jnp.asarray(lines), jnp.asarray(mask), jnp.asarray(pair_t),
        jnp.asarray(pair_tl), jnp.asarray(pair_sl), jnp.asarray(scenes[0]),
        lines.shape[1])
    got = tmatch._make_candidates(
        torch.as_tensor(lines), torch.as_tensor(pair_t)[None],
        torch.as_tensor(pair_tl)[None], torch.as_tensor(pair_sl)[None],
        torch.as_tensor(scenes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_geometry_products_round_without_launder():
    """``transform``/``align`` equal the JAX package's laundered products
    bit for bit, while the same sums with a fused multiply-add differ —
    so the equality is not an accident of the inputs."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-300, 300, (2000, 4)).astype(np.float32)
    b = rng.uniform(-300, 300, (2000, 4)).astype(np.float32)
    want_al = np.array(jgeo.align(jnp.asarray(a), jnp.asarray(b)))
    got_al = tgeo.align(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got_al, want_al)
    mats = jnp.asarray(want_al[:, 0])
    want_tr = np.asarray(jgeo.transform(jnp.asarray(a), mats))
    got_tr = tgeo.transform(torch.as_tensor(a), torch.as_tensor(want_al[:, 0])).numpy()
    np.testing.assert_array_equal(got_tr, want_tr)
    rot = torch.as_tensor(want_al[:, 0, :, :2])
    v, t = torch.as_tensor(a[:, :2]), torch.as_tensor(want_al[:, 0, 0, 2])
    fused = fma_f32(rot[:, 0, 0], v[:, 0], fma_f32(rot[:, 0, 1], v[:, 1], t))
    assert (fused.numpy() != got_tr[:, 0]).sum() > 50


def test_sqrt_and_divide_are_ieee():
    """The port's divide and :func:`sqrt_f32` equal numpy (IEEE, correctly
    rounded), including quotients beyond the JAX ``div_cr`` split range."""
    rng = np.random.default_rng(4)
    n = 200_000
    a = (rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-30, 38, n)).astype(np.float32)
    b = (rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-30, 38, n)).astype(np.float32)
    a[:500] = rng.uniform(1e36, 3e38, 500).astype(np.float32)
    b[:500] = rng.uniform(1.0, 4.0, 500).astype(np.float32)
    with np.errstate(all="ignore"):
        q, s = a / b, np.sqrt(np.abs(a))
    np.testing.assert_array_equal((torch.as_tensor(a) / torch.as_tensor(b)).numpy(), q)
    np.testing.assert_array_equal(tgeo.sqrt_f32(torch.as_tensor(np.abs(a))).numpy(), s)
