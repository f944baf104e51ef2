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


def test_minplus_plain_is_the_dense_min():
    """K2's plain version equals the dense O(W^2) definition, bit for bit."""
    rng = np.random.default_rng(2)
    g = rng.integers(0, 30, (20, 50)).astype(np.float32)
    g[:, rng.uniform(size=50) < 0.7] = F32_MAX
    g[3] = F32_MAX
    gt = torch.as_tensor(g)
    g2 = gt * gt
    l1 = tdt._nearest_1d_l1(gt)
    x = torch.arange(50, dtype=torch.float32)
    dense = (g2[:, None, :] + (x[:, None] - x[None, :]) ** 2).amin(dim=-1)
    got = minplus.minplus_rows(g2, l1)
    assert torch.equal(got, dense)
    assert torch.isinf(got[3]).all()
