"""Seeded K3 step lists that stress the kernels' read-ahead (numpy and the
port only: the card's test run imports it without JAX)."""
import numpy as np

from openfdcm_tpu_torch.matching import featuremap as tfm


def revisit_steps(depth, n, seed):
    """A seeded list that writes an index again 2 steps after writing it
    (its least revisit distance is 2): ``c2`` walks a seeded permutation of
    the depth axis, every fifth step writes the ``c2`` of two steps before,
    and ``c1`` is the previous ``c2`` on two steps of three (the chain)."""
    rng = np.random.default_rng(seed)
    cycle = rng.permutation(depth)
    c2 = [int(cycle[k % depth]) for k in range(n)]
    for k in range(2, n, 5):
        c2[k] = c2[k - 2]
    c1 = [c2[k - 1] if k % 3 else int(rng.integers(depth)) for k in range(n)]
    return [(a, b, float(w)) for a, b, w in
            zip(c1, c2, rng.uniform(0, 3, n).astype(np.float32))]


def self_steps(depth, repeats=1):
    """The reference pattern at ``depth``, every seventh step replaced by
    ``(c2, c2, w)`` (``c1 == c2``), ``repeats`` times over."""
    steps = list(tfm.propagation_steps(tfm.make_angles(depth), 5.0))
    for k in range(3, len(steps), 7):
        steps[k] = (steps[k][1], steps[k][1], steps[k][2])
    return steps * repeats
