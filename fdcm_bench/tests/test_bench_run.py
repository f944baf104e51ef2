"""A whole run of each cell on the CPU at test size: the result line's
keys, the comparison, and the refusals of the command line."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from fdcm_bench import harness
from fdcm_bench.tests.conftest import CELLS, ROOT


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("name", CELLS)
def test_result_line(small_cell, name, trace):
    spec, cell, config, traffic = small_cell(name)
    out = harness.run_cell(spec, cell, config, traffic, seed=2 ** 31 + 11, seconds=0.5,
                           trace=bool(trace), device="cpu", t0=time.perf_counter(),
                           log=lambda s: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["compared"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert {k: v["value"] for k, v in out["compared"].items()} == {"score_gap": 0.0,
                                                                 "rows_differ": 0}
    want = {m["name"] for m in harness.metrics_of(spec, cell, bool(trace))}
    assert set(out["metrics"]) <= want
    if not trace:     # a CPU run reports no device metric
        assert set(out["metrics"]) == want - {"device_peak_gib"}
    else:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


def test_same_seed_same_inputs(small_cell):
    from fdcm_bench import workload
    _, _, config, traffic = small_cell("pose.batch40")
    a = workload.make_inputs(config, 2 ** 32 + 5, traffic["pool"])
    b = workload.make_inputs(config, 2 ** 32 + 5, traffic["pool"])
    c = workload.make_inputs(config, 2 ** 32 + 6, traffic["pool"])
    assert all((x == y).all() for x, y in zip(a.scenes, b.scenes))
    assert not all(x.shape == y.shape and (x == y).all() for x, y in zip(a.scenes, c.scenes))


def command(cwd, *extra):
    return subprocess.run([sys.executable, "fdcm_bench/run.py", "--workload", "pose.batch40",
                           "--seed", "1", "--seconds", "1", *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    res = command(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "fdcm_bench"), tmp_path / "fdcm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = command(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of each cell on the card: correct, and its end-to-end
    metrics in the line."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    for name in CELLS:
        res = subprocess.run([sys.executable, "fdcm_bench/run.py", "--workload", name,
                              "--seed", "7", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["correct"] is True and out["device"]["platform"] == "gpu"
