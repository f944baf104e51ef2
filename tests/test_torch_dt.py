"""The PyTorch port's distance transforms against the JAX package on the CPU.

Bar: bit-equal (every DT value is an exact integer, its square root, or
``F32_MAX``).  The port's row pass runs kernel K2's plain version here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openfdcm_tpu.core import dt as jdt
from openfdcm_tpu.core.types import Distance as JDistance
from openfdcm_tpu_torch.core import dt as tdt
from openfdcm_tpu_torch.core.types import Distance, F32_MAX
from openfdcm_tpu_torch.ops import minplus

torch.set_num_threads(1)

METRICS = [Distance.L1, Distance.L2, Distance.L2_SQUARED]


def _indicator(seed, shape=(3, 48, 80), density=0.01):
    rng = np.random.default_rng(seed)
    ind = np.where(rng.uniform(size=shape) < density, 0.0, F32_MAX).astype(np.float32)
    ind[-1] = F32_MAX                          # an empty slice: all F32_MAX
    return ind


@pytest.mark.parametrize("metric", METRICS)
def test_dt_from_indicator_bit_equal(metric):
    ind = _indicator(0)
    want = np.asarray(jdt.dt_from_indicator(jnp.asarray(ind),
                                            metric=JDistance(int(metric))))
    got = tdt.dt_from_indicator(torch.as_tensor(ind), metric=metric).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == F32_MAX).all()


@pytest.mark.parametrize("metric", METRICS)
def test_row_pass_bit_equal(metric):
    rng = np.random.default_rng(1)
    g = rng.integers(0, 40, (2, 24, 64)).astype(np.float32)
    g[:, :, rng.uniform(size=64) < 0.6] = F32_MAX   # seedless columns
    g[1] = F32_MAX                                   # a seedless image
    want = np.asarray(jdt.row_pass(jnp.asarray(g), metric=JDistance(int(metric))))
    got = tdt.row_pass(torch.as_tensor(g), metric=metric).numpy()
    np.testing.assert_array_equal(got, want)


def _dense(g: np.ndarray, sqrt: bool) -> np.ndarray:
    """The O(W^2) definition on rows ``g (N, W)``: every candidate rounded
    as the band scan rounds it, the min, the clamp and the square root."""
    w = g.shape[-1]
    d = np.arange(w, dtype=np.float32)
    with np.errstate(over="ignore"):
        cand = (g * g)[:, None, :] + ((d[:, None] - d[None, :]) ** 2)[None]
    out = np.minimum(cand.min(axis=-1), np.float32(F32_MAX))
    if sqrt:
        out = np.where(out >= F32_MAX, out, np.sqrt(out.astype(np.float64)))
    return out.astype(np.float32)


@pytest.mark.parametrize("sqrt", [False, True])
def test_minplus_plain_is_the_dense_min(sqrt):
    """K2's plain version equals the dense O(W^2) definition, bit for bit."""
    rng = np.random.default_rng(2)
    g = rng.integers(0, 30, (20, 50)).astype(np.float32)
    g[:, rng.uniform(size=50) < 0.7] = F32_MAX
    g[3] = F32_MAX
    got = minplus.minplus_rows(torch.as_tensor(g), sqrt=sqrt).numpy()
    np.testing.assert_array_equal(got, _dense(g, sqrt))
    assert (got[3] == np.float32(F32_MAX)).all()


# -- a mirror of csrc/minplus.cu (edt_rows_kernel), step for step -----------

_EXACT = 1 << 24


def _i32(v: int) -> int:
    assert -(1 << 31) <= v < (1 << 31), v          # the kernel's int32 range
    return v


def _cost(x, s, gs):
    return _i32((x - s) * (x - s) + gs * gs)


def _numer(i, gi, u, gu):
    return _i32((u * u + gu * gu) - (i * i + gi * gi))


def _scan_value(gs, d):
    with np.errstate(over="ignore"):
        return np.float32(np.float32(gs) * np.float32(gs)) + \
            np.float32(np.float32(d) * np.float32(d))


def _far_mark(r: int) -> np.float32:
    """A far pixel's mark in the envelope's output: the sign bit over its
    band radius."""
    return np.array([0x80000000 | r], np.uint32).view(np.float32)[0]


def k2_mirror_row(grow: np.ndarray, sqrt: bool, fallback: bool = True,
                  defer: bool = False):
    """One row through the kernel's integer envelope: forward pops on the
    cross-multiplied intersection test, backward pointer walk, the winner's
    rounded value (the band scan's minimum within sqrt(v) + 2 of x when
    the exact value reaches 2^24), the square root.  ``defer``: as the
    envelope pass writes it, a far pixel's mark (radius at most W) in place
    of its band scan, for the far pass."""
    w = grow.shape[0]
    stack = []                                        # (s, g_s)
    for u in range(w):
        if not grow[u] < F32_MAX:
            continue                                  # seedless column
        gu = int(grow[u])
        while len(stack) >= 2:
            (sp, gp), (sq, gq) = stack[-2], stack[-1]
            if _numer(sq, gq, u, gu) * (sq - sp) <= _numer(sp, gp, sq, gq) * (u - sq):
                stack.pop()
            else:
                break
        stack.append((u, gu))
    out = np.full(w, np.float32(F32_MAX), np.float32)
    q = len(stack) - 1
    for x in range(w - 1, -1, -1) if stack else ():
        while q >= 1 and _cost(x, *stack[q - 1]) <= _cost(x, *stack[q]):
            q -= 1
        sq, gq = stack[q]
        exact = _cost(x, sq, gq)
        if exact < _EXACT or not fallback:
            v = _scan_value(gq, x - sq)
        elif defer:
            out[x] = _far_mark(min(int(np.sqrt(np.float32(exact), dtype=np.float32)) + 2, w))
            continue
        else:
            r = int(np.sqrt(np.float32(exact), dtype=np.float32)) + 2
            lo, hi = max(0, x - r), min(w - 1, x + r)
            v = min(_scan_value(grow[s], x - s) for s in range(lo, hi + 1))
        out[x] = np.float32(np.sqrt(np.float64(v))) if sqrt else v
    return out


def _k2_cases():
    rng = np.random.default_rng(7)
    fmax = np.float32(F32_MAX)
    sparse = np.where(rng.uniform(size=(12, 64)) < 0.15,
                      rng.integers(0, 40, (12, 64)), fmax).astype(np.float32)
    sparse[:, rng.uniform(size=64) < 0.5] = fmax     # seedless columns
    ties = np.full((4, 16), fmax, np.float32)
    ties[0, [0, 1, 2]] = [0, 1, 0]                   # equal intersections
    ties[1, [3, 9]] = 2                              # equal costs mid-way
    ties[2, [0, 4, 8, 12]] = 0
    ties[3, [2, 5]] = [3, 0]
    single = np.full((3, 24), fmax, np.float32)
    single[0, 0], single[1, 23], single[2, 11] = 5, 0, 17
    return {
        "sparse": sparse,
        "ties": ties,
        "seedless": np.full((3, 20), fmax, np.float32),
        "single_source": single,
        "all_sources": rng.integers(0, 50, (6, 40)).astype(np.float32),
        "w1": np.array([[0], [7], [fmax]], np.float32),
    }


@pytest.mark.parametrize("metric", [Distance.L2, Distance.L2_SQUARED])
@pytest.mark.parametrize("case", sorted(_k2_cases()))
def test_k2_mirror_matches_dense_and_jax(case, metric):
    g = _k2_cases()[case]
    sqrt = metric == Distance.L2
    got = np.stack([k2_mirror_row(r, sqrt) for r in g])
    np.testing.assert_array_equal(got, _dense(g, sqrt))
    want = np.asarray(jdt.row_pass(jnp.asarray(g), metric=JDistance(int(metric))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        minplus.minplus_rows(torch.as_tensor(g), sqrt=sqrt).numpy(), want)


def test_k2_mirror_beyond_the_exact_range():
    """Pixel 4093 of an 8191-px row lies exactly as far (in L2²) from a
    source 4093 px left (g 181) as from one 4097 px right (g 1): 16785410.
    The envelope takes the left one, whose rounded value is 16785410; the
    band scan's minimum is the right one's 16785408.  The kernel's scan
    beyond 2^24 gives the band scan's minimum there and everywhere else."""
    fmax = np.float32(F32_MAX)
    row = np.full(8191, fmax, np.float32)
    row[0], row[8190] = 181, 1
    x = 4093
    assert _cost(x, 0, 181) == _cost(x, 8190, 1) == 16785410
    assert k2_mirror_row(row, False, fallback=False)[x] == np.float32(16785410)
    for sqrt in (False, True):
        want = minplus.minplus_rows(torch.as_tensor(row[None]), sqrt=sqrt).numpy()[0]
        got = k2_mirror_row(row, sqrt)
        np.testing.assert_array_equal(got, want)
    assert want[x] == np.float32(np.sqrt(16785408.0))


# -- the far pass of csrc/minplus.cu (edt_far_kernel), lane for lane ---------

def k2_far_mirror(grow: np.ndarray, marked: np.ndarray, sqrt: bool) -> np.ndarray:
    """The far pass on one row: each marked pixel's band ``[x - r, x + r]``
    (clipped to the row) over 32 lanes, lane ``l`` taking sources ``lo + l,
    lo + l + 32, ...`` with the NaN-propagating min, then the xor-shuffle
    tree (offsets 16, 8, 4, 2, 1); lane 0's value, its root for L2."""
    w = grow.shape[0]
    with np.errstate(over="ignore"):
        g2 = grow * grow
    out = marked.copy()
    bits = marked.view(np.uint32)
    lane_ids = np.arange(32)
    for x in np.nonzero(bits & 0x80000000)[0]:
        r = int(bits[x] & 0x7FFFFFFF)
        lo, hi = max(0, x - r), min(w - 1, x + r)
        src = np.arange(lo, hi + 1)
        d = (x - src).astype(np.float32)
        cand = np.full(-(-len(src) // 32) * 32, np.inf, np.float32)
        cand[:len(src)] = g2[src] + d * d
        lanes = cand.reshape(-1, 32).min(axis=0)          # lane l: src lo + l + 32 i
        for o in (16, 8, 4, 2, 1):
            lanes = np.minimum(lanes, lanes[lane_ids ^ o])
        out[x] = np.float32(np.sqrt(np.float64(lanes[0]))) if sqrt else lanes[0]
    return out


def _far_rows():
    """Rows with pixels 2^12 px or more from every source: the tie row of
    ``test_k2_mirror_beyond_the_exact_range``, a 7000-px row whose sources
    all lie in its first 2000 px, and a 300-px row whose every pixel is far
    (column distances 4100-4999); with which of them the inline band scan's
    mirror and the dense definition (W^2 candidates) are quick enough to
    check."""
    fmax = np.float32(F32_MAX)
    rng = np.random.default_rng(11)
    tie = np.full(8191, fmax, np.float32)
    tie[0], tie[8190] = 181, 1
    tail = np.where(rng.uniform(size=7000) < 0.01, rng.integers(0, 60, 7000),
                    fmax).astype(np.float32)
    tail[2000:] = fmax
    every = rng.integers(4100, 5000, 300).astype(np.float32)
    return {"tie": (tie, True, False), "tail": (tail, False, False),
            "every": (every, True, True)}


@pytest.mark.parametrize("metric", [Distance.L2, Distance.L2_SQUARED])
@pytest.mark.parametrize("case", sorted(_far_rows()))
def test_k2_deferred_far_pass_mirror(case, metric):
    """The envelope pass marks every pixel whose winner's exact value
    reaches 2^24 and the far pass fills it: the two mirrors together equal
    the inline band scan, the plain version and (where W allows) the dense
    definition, bit for bit.  The lanes' order does not matter: no
    candidate is NaN."""
    row, inline, dense = _far_rows()[case]
    sqrt = metric == Distance.L2
    marked = k2_mirror_row(row, sqrt, defer=True)
    far = marked.view(np.uint32) >= 0x80000000
    assert far.any()
    if case == "every":
        assert far.all()
    got = k2_far_mirror(row, marked, sqrt)
    if inline:
        np.testing.assert_array_equal(got, k2_mirror_row(row, sqrt))
    plain = minplus.minplus_rows_plain(torch.as_tensor(row[None]), sqrt=sqrt).numpy()[0]
    np.testing.assert_array_equal(got, plain)
    if dense:
        np.testing.assert_array_equal(got, _dense(row[None], sqrt)[0])


def test_far_marks_work_and_plain_far_pass():
    """The host side of the far pass: ``far_marks`` decodes the envelope's
    marks (no K2 value has the sign bit), ``far_work`` counts the marked
    pixels, their band sources and rows, ``far_pass`` on CPU tensors runs
    its plain version in place, equal to ``minplus_rows_plain``, and the
    row list holds a count and one entry a row."""
    rows = _far_rows()
    g = np.full((3, 7000), np.float32(F32_MAX), np.float32)
    g[0] = rows["tail"][0]
    g[1, :300] = rows["every"][0]
    g[2, :7] = [0, 5, 9, F32_MAX, 2, 2, 1]            # no far pixel
    for sqrt in (False, True):
        marked = np.stack([k2_mirror_row(r, sqrt, defer=True) for r in g])
        bits = marked.view(np.uint32)
        want_far = bits >= 0x80000000
        radius = (bits & 0x7FFFFFFF).astype(np.int64)
        x = np.arange(7000)
        band = np.minimum(x + radius, 6999) - np.maximum(x - radius, 0) + 1
        out = torch.as_tensor(marked)
        far, r = minplus.far_marks(out)
        np.testing.assert_array_equal(far.numpy(), want_far)
        np.testing.assert_array_equal(r.numpy()[want_far], radius[want_far])
        assert minplus.far_work(out) == (int(want_far.sum()), int(band[want_far].sum()),
                                         int(want_far.any(axis=1).sum()))
        assert minplus.far_work(minplus.minplus_rows_plain(torch.as_tensor(g), sqrt=sqrt)) == (0, 0, 0)
        gt = torch.as_tensor(g)
        listing = torch.zeros(minplus.far_capacity(3), dtype=torch.int64)
        assert minplus.far_capacity(3) == 4
        want = minplus.minplus_rows_plain(gt, sqrt=sqrt)
        assert torch.equal(minplus.far_pass_plain(gt, out, listing, sqrt=sqrt), want)
        assert minplus.far_pass(gt, out, listing, sqrt=sqrt) is out
        assert torch.equal(out, want)
    with pytest.raises(ValueError):
        minplus.far_pass(gt, out, torch.zeros(3, dtype=torch.int64), sqrt=True)
    with pytest.raises(ValueError):
        minplus.envelope(gt, sqrt=True)               # the card's pass only
