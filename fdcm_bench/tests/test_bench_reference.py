"""The plain reference against a frozen copy of the numpy oracle, and its
distance transform against a brute force over every seed."""
import numpy as np
import pytest
import torch

from fdcm_bench import reference as R
from fdcm_bench.tests import oracle_frozen as oracle

F32 = np.float32


def random_case(seed, depth=12, size=(96, 80), lines=9):
    rng = np.random.default_rng(seed)
    w, h = size
    li = np.cumsum(rng.uniform(0, 4, (depth, h, w)), axis=2).astype(F32)
    ang = R.angles_of(depth)
    tmpl = np.concatenate([rng.uniform(25, 45, (lines, 2)),
                           rng.uniform(25, 45, (lines, 2))], 1).astype(F32)
    v = rng.normal(size=2)
    v = (v / np.linalg.norm(v)).astype(F32)
    tr = rng.uniform(-3, 3, 2).astype(F32)
    return li, ang, tmpl, v, tr, (w, h)


@pytest.mark.parametrize("seed", range(6))
def test_scores_equal_the_oracle(seed):
    li, ang, tmpl, v, tr, _ = random_case(seed)
    steps = np.arange(-5, 6, dtype=F32)
    want = oracle.evaluate(li, ang, tr, tmpl, [s * v for s in steps])
    cls = torch.as_tensor(R.orientation(ang, tmpl))[None]
    score = R.Scorer(torch.as_tensor(li), torch.as_tensor(tmpl)[None],
                     torch.ones((1, len(tmpl)), dtype=torch.bool), cls, torch.as_tensor(tr))
    got = score(torch.tensor([0]), torch.as_tensor(steps)[None], torch.as_tensor(v)[None])
    assert np.array_equal(got[0].numpy(), np.asarray(want, F32))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("batch", (5, 10))
def test_batch_walk_equals_the_oracle(seed, batch):
    li, ang, tmpl, v, tr, size = random_case(seed)
    want = oracle.batch_optimize(li, ang, tr, size, tmpl, v, batch)
    lines = torch.as_tensor(tmpl)[None]
    mask = torch.ones((1, len(tmpl)), dtype=torch.bool)
    step = R.step_vector(torch.as_tensor(v)[None])
    neg, pos = R.step_range(lines, mask, step, torch.tensor([float(size[0]), float(size[1])]),
                            torch.as_tensor(tr))
    cls = torch.as_tensor(R.orientation(ang, tmpl))[None]
    score = R.Scorer(torch.as_tensor(li), lines, mask, cls, torch.as_tensor(tr))
    s0 = score(torch.tensor([0]), torch.zeros((1, 1)), step)[:, 0]
    best, mul = R.walk(score, s0, torch.trunc(pos), torch.trunc(-neg), step, batch)
    assert want is not None
    assert np.float32(best[0]) == np.float32(want[0])
    assert np.array_equal((mul[:, None] * step)[0].numpy(), np.asarray(want[1], F32))


def test_step_range_equals_the_oracle():
    for seed in range(20):
        _, _, tmpl, v, tr, size = random_case(seed)
        want = oracle.minmax_translation(tmpl, oracle.rasterize_vector(v), size, tr)
        step = R.step_vector(torch.as_tensor(v)[None])
        neg, pos = R.step_range(torch.as_tensor(tmpl)[None],
                                torch.ones((1, len(tmpl)), dtype=torch.bool), step,
                                torch.tensor([float(size[0]), float(size[1])]),
                                torch.as_tensor(tr))
        assert np.allclose([float(neg[0]), float(pos[0])], want, rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(3))
def test_distance_is_exact(seed):
    rng = np.random.default_rng(seed)
    ind = torch.as_tensor(rng.random((3, 17, 23)) < 0.03)
    ind[2] = False                                 # a slice without seeds
    got = R.distance(ind, torch.float32)
    ys, xs = np.mgrid[0:17, 0:23]
    for d in range(3):
        pts = np.argwhere(ind[d].numpy())
        if len(pts) == 0:
            assert bool((got[d] == R.F32_MAX).all())
            continue
        d2 = ((ys[..., None] - pts[:, 0]) ** 2 + (xs[..., None] - pts[:, 1]) ** 2).min(-1)
        assert np.array_equal(got[d].numpy(), np.sqrt(d2).astype(F32))


def test_orientation_equals_the_oracle():
    rng = np.random.default_rng(0)
    lines = rng.uniform(-50, 50, (400, 4)).astype(F32)
    for depth in (12, 30):
        ang = R.angles_of(depth)
        d = lines[:, 2:4] - lines[:, 0:2]
        theta = np.arctan(d[:, 1] / d[:, 0]).astype(F32)
        want = [oracle.closest_orientation_idx(ang, float(t)) for t in theta]
        assert R.orientation(ang, lines).tolist() == want
