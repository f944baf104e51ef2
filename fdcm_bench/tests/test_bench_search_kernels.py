"""The reader of ``search_kernels_ms_per_scene`` on a synthetic device trace,
and a whole run of ``tless.frame`` on the CPU at test size."""
import time
from types import SimpleNamespace

import pytest
import torch

from fdcm_bench import harness
from fdcm_bench.devtrace import Trace

CUDA = torch.autograd.DeviceType.CUDA
US = 1000


class Event:
    """The parts of a ``_KinetoEvent`` the trace reads."""

    def __init__(self, name, start, end):
        self._name, self._s, self._e = name, start * US, end * US

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return CUDA

    def is_user_annotation(self):
        return False


def trace_of(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return Trace(prof, 0, 10_000 * US)


def run_of(trace, done=4):
    return SimpleNamespace(trace=trace, record=SimpleNamespace(done=[0] * done))


READ = harness.reader("search_kernels_ms_per_scene")


def test_sums_only_the_search_kernels():
    events = [
        Event("void window_kernel<false>(float const*, long long)", 100, 400),    # K1
        Event("window_v2_kernel", 500, 600),                                       # K5
        Event("window_v3_kernel", 700, 750),                                       # K6
        Event("tile_kernel(float const*, float4*)", 800, 820),                     # tiled copy
        Event("decide_kernel", 900, 905),                                          # walks
        Event("edt_rows_kernel", 1000, 3000),                                      # K2: not search
        Event("prop_fixed<30, 2>", 3000, 3500),                                    # K3
        Event("sweep_paths_kernel", 3500, 3600),                                   # K4
        Event("Memcpy HtoD (Pageable -> Device)", 4000, 4100),
        Event("void at::native::elementwise_kernel<128, 4>", 4200, 4300),
    ]
    got = READ(run_of(trace_of(events), done=5))
    assert got == pytest.approx(1e3 * (300 + 100 + 50 + 20 + 5) * 1e-6 / 5)


def test_nothing_to_read():
    assert READ(run_of(None)) is None
    assert READ(run_of(trace_of([Event("edt_rows_kernel", 0, 10)]))) is None
    assert READ(run_of(trace_of([Event("window_kernel", 0, 10)]), done=0)) is None


@pytest.mark.parametrize("trace", (0, 1))
def test_tless_frame_at_test_size(small_cell, trace):
    """The cell runs end to end on the CPU, its answers equal the plain
    reference's; no kernel runs there, so the new reader reads nothing."""
    spec, cell, config, traffic = small_cell("tless.frame")
    assert config["inputs"]["banks"] == 2 and traffic["kind"] == "closed_loop"
    out = harness.run_cell(spec, cell, config, traffic, seed=2 ** 31 + 13, seconds=0.5,
                           trace=bool(trace), device="cpu", t0=time.perf_counter(),
                           log=lambda s: None)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert {k: v["value"] for k, v in out["compared"].items()} == {"score_gap": 0.0,
                                                                 "rows_differ": 0}
    want = {m["name"] for m in harness.metrics_of(spec, cell, bool(trace))}
    if trace:
        assert "search_kernels_ms_per_scene" in want
        assert "search_kernels_ms_per_scene" not in out["metrics"]
    else:
        assert set(out["metrics"]) == want - {"device_peak_gib"}
