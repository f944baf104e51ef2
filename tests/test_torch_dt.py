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


def k2_mirror_row(grow: np.ndarray, sqrt: bool, fallback: bool = True):
    """One row through the kernel's integer envelope: forward pops on the
    cross-multiplied intersection test, backward pointer walk, the winner's
    rounded value (the band scan's minimum within sqrt(v) + 2 of x when
    the exact value reaches 2^24), the square root."""
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
