"""Helpers of the benchmark's CPU tests: each cell at a size a CPU test
holds (the same code, fewer and smaller templates and scenes)."""
import copy
import os
import sys

import pytest
import torch

# several test workers share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fdcm_bench import harness  # noqa: E402

CELLS = ("general.batch8", "pose.batch40", "general.frame", "pose.cameras4")


def shrink(config: dict, traffic: dict):
    """The configuration and traffic of a cell, cut to CPU-test size."""
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    inputs = config["inputs"]
    if inputs["kind"] == "random_banks":
        inputs.update(banks=2, templates_per_bank=4, scene_extent_px=200.0,
                      template_reach_px=90.0, clutter_lines=20,
                      clutter_margin_px=40.0, template_half_extent_px=35.0,
                      line_length_px=[5.0, 40.0])
    else:
        inputs["shapes"][0].update(lines=10, extent_px=80.0,
                                   line_length_px=[5.0, 30.0], scales=[0.5, 0.8, 3])
        inputs["shapes"][1].update(lines=12, extent_px=70.0,
                                   line_length_px=[5.0, 25.0], scales=[0.6, 1.0, 2])
        inputs.update(frame_px=[200, 110], frame_lines=50, clutter_length_px=[5.0, 30.0])
    traffic.update(pool=4, sample=2, warm_rounds=1)
    if traffic["kind"] == "batch":
        traffic.update(scenes_per_call=2, calls_per_pass=min(traffic["calls_per_pass"], 2))
    else:
        traffic.update(clients=min(traffic["clients"], 2))
    return config, traffic


@pytest.fixture
def small_cell():
    """``small_cell(name) -> (spec, cell, config, traffic)`` at CPU size."""
    spec = harness.load_spec()

    def make(name):
        cell, _, config, traffic = harness.resolve(spec, name)
        return (spec, cell, *shrink(config, traffic))
    return make
