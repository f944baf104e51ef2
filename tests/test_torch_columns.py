"""The column pass in one launch (``ops/columns.py``, ``csrc/columns.cu``).

On the CPU: a Python mirror of the kernel's two chunked sweeps (segments,
chunks held in registers, the suffix scratch, the carries between
segments), in float32 tensors over all columns at once, is held bit-equal
to the plain version (``core/dt.py::_nearest_1d_l1(f, dim=-2)``) and, on
finite inputs, to the JAX package's ``_nearest_1d_l1`` on the transposed
input; the wrapper's input checks, its CPU path and its counter.

On the card (marker ``gpu``; JAX is imported only by the CPU parity test):
the kernel bit-equal to the plain version at the main path's stack shapes,
on canvases beyond 16,384 px, an odd width, NaN and ±inf; the in-place call
with a scratch under a tenth of the stack; and whole DT3 builds of both
notebook configurations equal to the builds with the plain column pass.
"""
import json
import os
import zlib

import numpy as np
import pytest
import torch

from openfdcm_tpu_torch import profiling
from openfdcm_tpu_torch.core.dt import _nearest_1d_l1
from openfdcm_tpu_torch.core.types import F32_MAX
from openfdcm_tpu_torch.ops import columns

F32 = np.float32
INF = float("inf")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan_min(m, x):
    """One step of torch.cummin, as the kernel's ``scan_min``."""
    return torch.where(~m.isnan() & (x.isnan() | (x < m)), x, m)


def _min_nan(a, b):
    """torch.minimum, as the kernel's ``min_nan``."""
    return torch.where(a.isnan(), a, torch.where(b.isnan(), b, torch.where(b < a, b, a)))


def mirror(f, chunk):
    """The kernel's sweeps on ``f (..., H, W)``, in its order: bottom-up over
    every chunk of ``chunk`` rows but the top one, the running minimum of
    ``f + y`` stored at each chunk's top (the scratch); then top-down, each
    chunk's backward minima from the next chunk's entry up, and the forward
    minimum carried down through it."""
    h, w = f.shape[-2:]
    x = f.reshape(-1, h, w).permute(1, 0, 2).reshape(h, -1)     # rows x columns
    inf = torch.full(x.shape[1:], INF)
    chunks = -(-h // chunk)
    rows = lambda c: range(c * chunk, min(h, (c + 1) * chunk))
    suffix, m = {}, inf
    for c in range(chunks - 1, 0, -1):
        for y in rows(c):
            m = _scan_min(m, x[y] + float(y))
        suffix[c - 1] = m
    out = torch.empty_like(x)
    fwd = inf
    for c in range(chunks):
        bwd = suffix[c] if c + 1 < chunks else inf
        b = {}
        for y in reversed(rows(c)):
            bwd = _scan_min(bwd, x[y] + float(y))
            b[y] = bwd
        for y in rows(c):
            fwd = _scan_min(fwd, x[y] - float(y))
            out[y] = _min_nan(float(y) + fwd, -float(y) + b[y])
    return out.reshape(h, -1, w).permute(1, 0, 2).reshape(f.shape)


def _same(got, want):
    """Bit-equal, NaN equal to NaN (any payload)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _indicator(rng, shape, density):
    return np.where(rng.uniform(size=shape) < density, 0.0, F32_MAX).astype(F32)


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "empty":
        return np.full((2, 3, 37, 41), F32_MAX, F32)
    if name == "every_row":
        return np.zeros((2, 70, 9), F32)
    if name == "ends":
        f = np.full((3, 70, 12), F32_MAX, F32)
        f[:, 0], f[:, -1] = 0.0, 0.0
        return f
    if name == "h1":
        return _indicator(rng, (2, 1, 50), 0.5)
    if name == "w1":
        return _indicator(rng, (3, 99, 1), 0.05)
    if name == "ragged":                 # H a multiple of neither chunk
        return _indicator(rng, (1, 2, 83, 20), 0.03)
    if name.startswith("density"):
        return _indicator(rng, (2, 2, 96, 40), float(name.split("_")[1]))
    if name == "finite":                 # any finite floats, ties, -0
        f = rng.uniform(-200, 200, (2, 75, 33)).astype(F32)
        f[:, ::7] = np.round(f[:, ::7])
        f[0, 0, :5] = -0.0
        f[1, 3] = rng.uniform(-1e30, 1e30, 33)
        f[1, 9] = rng.uniform(-1e-30, 1e-30, 33)
        return f
    if name == "huge":                   # F32_MAX + y and -F32_MAX - y round
        f = rng.choice(np.array([F32_MAX, -F32_MAX, 3.0e38, 0.0], F32), (2, 64, 8))
        return f
    if name == "2d":
        return _indicator(rng, (67, 45), 0.02)
    if name == "4d":
        return _indicator(rng, (2, 3, 40, 24), 0.01)
    if name == "nan_inf":
        f = rng.uniform(-50, 50, (3, 81, 17)).astype(F32)
        f[0, 5, 2] = f[0, 60, 2] = np.nan
        f[1, 40, :] = np.nan
        f[2, 10, 3], f[2, 70, 4] = np.inf, -np.inf
        f[2, :, 5] = np.inf
        f[2, :, 6] = -np.inf
        f[0, 33:, 7] = np.nan
        return f
    raise KeyError(name)


FINITE = ["empty", "every_row", "ends", "h1", "w1", "ragged", "density_0.002",
          "density_0.05", "density_0.5", "finite", "huge", "2d", "4d"]


@pytest.mark.parametrize("name", FINITE + ["nan_inf"])
@pytest.mark.parametrize("chunk", [columns.CHUNK, 7, 16, 4096])
def test_mirror_equals_plain(name, chunk):
    """The kernel's sweeps, in chunks of its own height and of others (a
    column of one chunk among them), equal the plain version bit for bit."""
    f = torch.as_tensor(_case(name))
    _same(mirror(f, chunk), _nearest_1d_l1(f, dim=-2))


@pytest.mark.parametrize("name", FINITE)
def test_mirror_equals_jax(name):
    """On finite inputs the mirror equals the JAX package's column pass,
    which runs along the last axis: on the transposed input."""
    jnp = pytest.importorskip("jax.numpy")
    from openfdcm_tpu.core import dt as jdt
    f = _case(name)
    want = np.swapaxes(np.array(jdt._nearest_1d_l1(
        jnp.asarray(np.swapaxes(f, -1, -2)))), -1, -2)
    got = mirror(torch.as_tensor(f), columns.CHUNK)
    _same(got, torch.as_tensor(np.ascontiguousarray(want)))


@pytest.mark.parametrize("fn", [columns.column_pass, columns.column_pass_])
def test_wrapper_checks_its_input(fn):
    f = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="need"):
        fn(torch.zeros(6))
    with pytest.raises(ValueError, match="float32"):
        fn(f.double())
    with pytest.raises(ValueError, match="contiguous"):
        fn(f.t())


def test_cpu_tensors_take_the_plain_version():
    f = torch.as_tensor(_case("nan_inf"))
    before = columns.column_pass.launches
    want = _nearest_1d_l1(f, dim=-2)
    kept = f.clone()
    _same(columns.column_pass(f), want)
    _same(f, kept)                       # the out-of-place call leaves f
    g = f.clone()
    assert columns.column_pass_(g) is g
    _same(g, want)
    empty = torch.zeros(2, 0, 5)
    assert columns.column_pass_(empty) is empty
    assert columns.column_pass(empty).shape == empty.shape
    assert columns.column_pass.launches == before


def test_launch_counter_is_listed():
    assert "column_pass.launches" in profiling.counts()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_on_card(got, want):
    """:func:`_same` on the card, without copying the stacks to the host."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = want.isnan()
    bits = got.view(torch.int32) == want.view(torch.int32)
    assert bool((got.isnan() == nan).all())
    assert bool((bits | nan).all())


def _card_indicator(shape, density, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(shape, generator=gen, device=device)
    return torch.where(u < density, 0.0, F32_MAX)


@gpu
@pytest.mark.parametrize("shape,density", [((8, 30, 1920, 1920), 2e-4),
                                           ((10, 30, 640, 640), 4e-4)])
def test_kernel_at_the_main_path_shapes(cuda, shape, density):
    """The 1080p batch's and the pose batch's stacks (sparse seeds, seedless
    columns among them), both calls, against the plain version."""
    f = _card_indicator(shape, density, 1, cuda)
    want = _nearest_1d_l1(f, dim=-2)
    before = columns.column_pass.launches
    _same_on_card(columns.column_pass(f), want)
    assert columns.column_pass_(f) is f
    _same_on_card(f, want)
    assert columns.column_pass.launches == before + 2


@gpu
@pytest.mark.parametrize("shape", [(1080, 16400), (16400, 64), (3, 5, 100, 33),
                                   (2, 1, 1, 70), (4, 333, 1)])
def test_kernel_on_wide_tall_and_odd_canvases(cuda, shape):
    """K2's wide canvases (a side above 16,384), a width that splits warps
    across planes, one row, one column."""
    f = _card_indicator(shape, 1e-3, 2, cuda)
    _same_on_card(columns.column_pass(f), _nearest_1d_l1(f, dim=-2))


@gpu
@pytest.mark.parametrize("name", FINITE + ["nan_inf"])
def test_kernel_equals_plain_on_every_case(cuda, name):
    f = torch.as_tensor(_case(name), device=cuda)
    _same_on_card(columns.column_pass(f), _nearest_1d_l1(f, dim=-2))


@gpu
def test_kernel_nan_and_inf_at_scale(cuda):
    """Random floats with NaN and ±inf sprinkled over a 640² stack."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    f = torch.rand((2, 30, 640, 640), generator=gen, device=cuda) * 1000 - 500
    u = torch.rand(f.shape, generator=gen, device=cuda)
    f[u < 1e-5] = float("nan")
    f[(u > 0.5) & (u < 0.5 + 1e-4)] = float("inf")
    f[u > 1 - 1e-4] = -float("inf")
    _same_on_card(columns.column_pass(f), _nearest_1d_l1(f, dim=-2))


@gpu
def test_in_place_call_allocates_no_stack(cuda):
    """In place, the pass allocates its scratch only: under a tenth of the
    stack above what was allocated before."""
    f = _card_indicator((10, 30, 640, 640), 4e-4, 4, cuda)
    stack = f.numel() * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    columns.column_pass_(f)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < stack / 10


def _notebook(name):
    with open(os.path.join(ROOT, "fdcm_bench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


@gpu
@pytest.mark.parametrize("name", ["general_notebook", "pose_notebook"])
def test_notebook_builds_equal_the_plain_column_pass(cuda, name, monkeypatch):
    """A DT3 stack of each notebook configuration's scenes, built with the
    kernel, equals the stack built with the plain column pass."""
    import sys
    sys.path.insert(0, ROOT)
    from fdcm_bench import workload
    import openfdcm_tpu_torch as ot
    from openfdcm_tpu_torch.matching import pipeline
    config = _notebook(name)
    m = config["matching"]
    params = ot.Dt3Params(m["depth"], m["dt3_coeff"], m["padding"],
                          ot.Distance[m["distance"]])
    scenes = workload.make_inputs(config, 2 ** 31 + 11, 2).scenes
    before = columns.column_pass.launches
    got = ot.build_featuremap_batch(scenes, params, pad_to=m["pad_to"],
                                    device=cuda).dt3
    assert columns.column_pass.launches == before + 1
    monkeypatch.setattr(pipeline, "column_pass_",
                        lambda f: f.copy_(_nearest_1d_l1(f, dim=-2)))
    want = ot.build_featuremap_batch(scenes, params, pad_to=m["pad_to"],
                                     device=cuda).dt3
    _same_on_card(got, want)
