"""The device trace charged to the program's spans
(``progtrace.ProgramTrace``) on a synthetic trace, the readers of the
metrics that read the program's spans and counters, and one CPU run of
``split.py``'s windows."""
from types import SimpleNamespace

import pytest
import torch

from fdcm_bench import harness, split
from fdcm_bench.devtrace import Trace
from fdcm_bench.progtrace import OUTSIDE, ProgramTrace, innermost, shifted

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, OTHER = 7, 99          # two threads that record spans
US = 1000                    # the times below are in us


class Event:
    """The parts of a ``_KinetoEvent`` the traces read."""

    def __init__(self, name, start, end, device, corr=0):
        self._name, self._s, self._e = name, start * US, end * US
        self._dev, self._corr = device, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._corr


def prof_of(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


# program spans, as recorded: (name, start, end, thread, id, parent, call)
SPANS = [("build.columns", 100, 300, MAIN, 2, 1, 1),
         ("walks.sync", 600, 700, MAIN, 4, 3, 1),
         ("walks.loop", 400, 900, MAIN, 3, 1, 1),
         ("match.call", 0, 1000, MAIN, 1, None, 1),
         ("collect.rows", 1000, 1200, OTHER, 5, None, 1),
         ("serve.queue", 0, 1100, MAIN, 6, None, 1)]
EVENTS = [
    Event("cudaLaunchKernel", 150, 155, CPU, corr=1),
    Event("edt_rows_kernel", 160, 250, CUDA, corr=1),           # build.columns
    Event("cudaLaunchKernel", 650, 652, CPU, corr=2),
    Event("window_kernel", 700, 720, CUDA, corr=2),             # walks.sync
    Event("cudaLaunchKernel", 950, 952, CPU, corr=3),
    Event("elementwise", 960, 980, CUDA, corr=3),               # match.call
    Event("Memcpy HtoD", 985, 1010, CUDA, corr=4),              # no launch seen
    Event("cudaLaunchKernel", 420, 421, CPU, corr=5),
    Event("sweep_paths_kernel", 430, 440, CUDA, corr=5),        # walks.loop
    Event("cudaMemcpyAsync", 1100, 1101, CPU, corr=6),
    Event("Memcpy DtoH", 1150, 1160, CUDA, corr=6),             # collect.rows
]


def trace(offset=0):
    host = [("match_many", 0, 1300 * US)]
    return ProgramTrace(prof_of(EVENTS), 0, 1300 * US, host, shifted(
        [(n, s * US - offset, e * US - offset, *rest) for n, s, e, *rest in SPANS], offset))


def test_innermost_segments():
    assert innermost([("a", 0, 100), ("b", 10, 20), ("c", 30, 40), ("d", 35, 38)]) == [
        (0, 10, "a", 100), (10, 20, "b", 10), (20, 30, "a", 100), (30, 35, "c", 10),
        (35, 38, "d", 3), (38, 40, "c", 10), (40, 100, "a", 100)]


@pytest.mark.parametrize("offset", [0, 1_792_330_135_632_034_787])
def test_operations_charged_to_the_launching_span(offset):
    t = trace(offset)
    assert t.charge() == {"build.columns": 90e-6, "match.call": 20e-6, "walks.sync": 20e-6,
                          OUTSIDE: 25e-6, "walks.loop": 10e-6, "collect.rows": 10e-6}
    assert t.unlaunched == 1
    assert t.charge_of(["edt_rows", "sweep_paths"]) == {"build.columns": 90e-6,
                                                         "walks.loop": 10e-6}


def test_idle_gaps_named_by_program_spans():
    t = trace()
    gaps = dict(t.idle_gaps(top=None))
    named = {n for n, _ in t.idle_gaps(top=None)}
    assert "serve.queue" not in named
    # the gaps: [0,160] mid 80 match.call; [250,430] mid 340 match.call;
    # [440,700] mid 570 walks.loop; [720,960] mid 840 walks.loop;
    # [980,985] under 10 us; [1010,1150] mid 1080 collect.rows (another
    # thread); [1160,1300] mid 1230 the benchmark's match_many
    assert gaps["match.call"] == pytest.approx((160 + 180) * 1e-6)
    assert gaps["walks.loop"] == pytest.approx((260 + 240) * 1e-6)
    assert gaps["gaps_under_10_us"] == pytest.approx(5e-6)
    assert gaps["collect.rows"] == pytest.approx(140e-6)
    assert gaps["match_many"] == pytest.approx(140e-6)
    assert t.idle_by_prefix("walks.") == pytest.approx(500e-6)


def run_of(t, done=4, counts=None):
    return SimpleNamespace(trace=t, record=SimpleNamespace(done=[0] * done),
                           counts=counts)


def test_readers_of_the_program_spans():
    t = trace()
    run = run_of(t, counts={"copies.h2d": 10, "copies.d2h": 2})
    w = t.window_s
    assert harness.reader("walks_idle_pct.batch")(run) == pytest.approx(100 * 500e-6 / w)
    assert harness.reader("walks_idle_pct.latency")(run) == pytest.approx(100 * 500e-6 / w)
    assert harness.reader("collect_idle_pct.latency")(run) == pytest.approx(100 * 140e-6 / w)
    assert harness.reader("build_device_ms_per_scene")(run) == pytest.approx(1e3 * 90e-6 / 4)
    assert harness.reader("serve_wait_ms")(run) == pytest.approx(1.1)
    assert harness.reader("host_copies_per_scene.latency")(run) == 3.0


def test_readers_read_nothing_without_the_program():
    plain = Trace(prof_of(EVENTS), 0, 1300 * US, [("match_many", 0, 1300 * US)])
    for name in ("walks_idle_pct.batch", "collect_idle_pct.latency",
                 "build_device_ms_per_scene", "serve_wait_ms",
                 "host_copies_per_scene.latency"):
        assert harness.reader(name)(run_of(plain)) is None
        assert harness.reader(name)(run_of(None)) is None


@pytest.mark.parametrize("name", ["pose.batch40", "pose.cameras4"])
def test_split_windows_on_the_cpu(small_cell, name):
    spec, cell, config, traffic = small_cell(name)
    out = split.measure(spec, cell, config, traffic, seed=2 ** 31 + 3, seconds=0.3,
                        windows=["trace+spans", "plain"], device="cpu", log=lambda s: None)
    traced, plain = out
    assert traced["spans"] > 0 and plain["spans"] == 0 and "idle_gaps" not in plain
    assert traced["scenes"] > 0 and plain["scenes"] > 0 and traced["failed"] == 0
    want = split.NEW_METRICS["scenes_per_s" if name == "pose.batch40" else "latency_p95_ms"]
    assert set(want) <= set(traced["per_layer"])
    if name == "pose.cameras4":
        assert traced["per_layer"]["serve_wait_ms"] > 0
