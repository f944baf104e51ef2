"""Per-stage wall time and traces (port of :mod:`openfdcm_tpu.profiling`).

Two forms:

* :func:`stage` blocks, module-level as in the JAX package: each both
  annotates the profiler timeline (``torch.profiler.record_function``) and
  adds its host wall time to a per-name total (:func:`report`,
  :func:`reset`); :func:`start_trace` / :func:`stop_trace` record a
  ``torch.profiler`` trace and write it as a Chrome trace;
* a :class:`StageTimer`, created by the caller and passed to
  ``match_many(..., timer=...)``; each of its stages ends with a device
  synchronize so its time covers the device work, not only the launches.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_totals: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_trace: dict = {}


@contextlib.contextmanager
def stage(name: str, sync: bool = False):
    """Annotate and time a pipeline stage.  ``sync=True`` waits for the
    card's queued work (when this process uses CUDA) before stopping the
    clock; otherwise the time covers the host side only."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _totals[name] += time.perf_counter() - t0
    _counts[name] += 1


def report() -> dict:
    """Per-stage ``{name: (total_s, calls)}`` accumulated so far."""
    return {k: (_totals[k], _counts[k]) for k in _totals}


def reset() -> None:
    _totals.clear()
    _counts.clear()


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of the host and, when CUDA is
    available, the card; :func:`stop_trace` writes it into ``log_dir``."""
    if _trace:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _trace.update(prof=prof, dir=log_dir)


def stop_trace() -> str:
    """Stop the trace and write it as a Chrome trace (``chrome://tracing``,
    Perfetto); returns the file's path."""
    prof, log_dir = _trace.pop("prof"), _trace.pop("dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


class StageTimer:
    """Accumulates ``{stage: seconds}`` over calls."""

    def __init__(self):
        self.totals: dict = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, device):
        t0 = time.perf_counter()
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0


@contextlib.contextmanager
def maybe_stage(timer: StageTimer | None, name: str, device):
    """``timer.stage(name, device)``, or nothing (and no sync) without a timer."""
    if timer is None:
        yield
    else:
        with timer.stage(name, device):
            yield
