"""Small seeded problems shared by the port's parity tests."""
import numpy as np

from tests.utils import create_lines, make_rotation


def three_scene_problem():
    """Three scenes holding a rotated, shifted 10-line template among six
    clutter lines, and three templates: ``(scenes, templates)``."""
    tmpl = np.asarray(create_lines(10, 80))
    rng = np.random.default_rng(5)
    scenes = []
    for angle, shift in ((np.pi, 3.0), (0.9, 6.0), (-0.5, 11.0)):
        rot = make_rotation(angle)
        placed = (tmpl.reshape(-1, 2) @ rot.T).reshape(-1, 4) + np.float32(shift)
        clutter = rng.uniform(-60, 80, (6, 4)).astype(np.float32)
        scenes.append(np.concatenate([placed, clutter]).astype(np.float32))
    templates = [tmpl, tmpl * np.float32(0.7), tmpl[:6] * np.float32(1.2)]
    return scenes, templates


def assert_same_matches(got, want, *, ordered=True, exact=False):
    """Per-scene match lists of the same length; ids equal; scores rtol 1e-6
    (equal with ``exact``); transforms atol 1e-5 (equal with ``exact``).
    ``ordered=False`` compares the lists after a stable sort by score."""
    assert len(got) == len(want)
    n = 0
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list)
        if not ordered:
            g_list = sorted(g_list, key=lambda m: m.score)
            w_list = sorted(w_list, key=lambda m: m.score)
        for g, w in zip(g_list, w_list):
            assert g.tmpl_idx == w.tmpl_idx
            if exact:
                assert g.score == w.score
                np.testing.assert_array_equal(g.transform, w.transform)
            else:
                assert np.isclose(g.score, w.score, rtol=1e-6, atol=0)
                np.testing.assert_allclose(g.transform, w.transform,
                                           rtol=1e-6, atol=1e-5)
            n += 1
    return n
