"""The comparison sees a broken timed path: a run with a fault planted
under the program's entry points, in the top-k collect or in the DT3
build, comes out not correct with the traffic's own sample size, and the
control (the reference in bfloat16) fails the limits."""
import time

import numpy as np
import pytest
import torch

from fdcm_bench import compare, control, harness
from fdcm_bench.tests.conftest import CELLS
from openfdcm_tpu_torch.matching import pipeline


def altered(collect_rows):
    """Every scene's best row moved: its score up by a thousandth."""
    def collect():
        out = collect_rows()
        return [[(s * 1.001 if j == 0 else s, t, m) for j, (s, t, m) in enumerate(rows)]
                for rows in out]
    return collect


def half_left_out(collect_rows):
    """The second half of every batch (a lone scene too) answered with
    nothing."""
    def collect():
        out = collect_rows()
        keep = len(out) // 2
        return out[:keep] + [[] for _ in out[keep:]]
    return collect


FAULTS = {"altered_answer": altered, "half_batch_left_out": half_left_out}


def run(spec, cell, config, traffic):
    return harness.run_cell(spec, cell, config, traffic, seed=17, seconds=0.5, trace=False,
                            device="cpu", t0=time.perf_counter(), log=lambda s: None)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(small_cell, monkeypatch, name, fault):
    spec, cell, config, traffic = small_cell(name)
    if fault == "half_batch_left_out" and traffic["kind"] == "closed_loop" \
            and traffic["entry"] != "service":
        pytest.skip("one scene a call: no batch to halve")
    dispatch = pipeline._genpairs_batch_dispatch
    monkeypatch.setattr(pipeline, "_genpairs_batch_dispatch",
                        lambda *a, **k: FAULTS[fault](dispatch(*a, **k)))
    assert run(spec, cell, config, traffic)["correct"] is False


def slice_raised(dt3):
    """One orientation slice of every distance stack a thousandth of a
    pixel high, before its line integrals."""
    dt3[:, dt3.shape[1] // 3] += 1e-3
    return dt3


def slices_rolled(stack):
    """Each orientation's line integrals read from its neighbour's slice."""
    return torch.roll(stack, 1, dims=1)


BUILD_FAULTS = {"slice_raised": ("fm", "propagate_orientation_relax", slice_raised),
                "slices_rolled": ("integral", "line_integral_stack_batch_", slices_rolled),
                "relaxation_skipped": ("fm", "propagate_orientation_relax", None)}


@pytest.mark.parametrize("fault", BUILD_FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_build_fault_is_not_correct(small_cell, monkeypatch, name, fault):
    """A wrong DT3 stack fails the comparison: a slice off by a thousandth,
    the slices out of place by one, the orientation relaxation (K3)
    left out."""
    spec, cell, config, traffic = small_cell(name)
    module, attr, change = BUILD_FAULTS[fault]
    target = getattr(pipeline, module)
    original = getattr(target, attr)
    if change is None:
        monkeypatch.setattr(target, attr, lambda dt3, steps: dt3)
    else:
        monkeypatch.setattr(target, attr, lambda *a, **k: change(original(*a, **k)))
    assert run(spec, cell, config, traffic)["correct"] is False


@pytest.mark.parametrize("name", ("pose.batch40", "general.frame"))
def test_control_fails(small_cell, name):
    _, _, config, traffic = small_cell(name)
    for seed in (1, 2, 3):
        got = control.numbers(config, traffic, seed, "cpu")
        assert not compare.verdict(got, config["limits"]), got


def test_numbers_of_equal_rows_are_zero():
    from types import SimpleNamespace
    from fdcm_bench.reference import Row
    rows = [Row(0.5 + i, i % 3, np.full((2, 3), i, np.float32)) for i in range(12)]
    answer = [SimpleNamespace(tmpl_idx=r.template, score=r.score, transform=r.transform)
              for r in rows[:10]]
    assert compare.scene_numbers(answer, rows, 10) == {"score_gap": 0.0, "rows_differ": 0}
    answer[3].score *= 1.01
    assert compare.scene_numbers(answer, rows, 10)["score_gap"] > 1e-3
    answer[3].tmpl_idx = 2
    assert compare.scene_numbers(answer, rows, 10)["rows_differ"] == 2
