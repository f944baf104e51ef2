"""Per-stage wall time, spans, counters and traces (port of
:mod:`openfdcm_tpu.profiling`).

Four forms:

* :func:`stage` blocks, module-level as in the JAX package: each both
  annotates the profiler timeline (``torch.profiler.record_function``) and
  adds its host wall time to a per-name total (:func:`report`,
  :func:`reset`); :func:`start_trace` / :func:`stop_trace` record a
  ``torch.profiler`` trace and write it as a Chrome trace;
* a :class:`StageTimer`, created by the caller and passed to
  ``match_many(..., timer=...)``; each of its stages ends with a device
  synchronize so its time covers the device work, not only the launches;
* :func:`span` blocks at every layer boundary of the matching path: off by
  default (one flag check, no clock read), recorded in memory between
  :func:`record_spans` ``(True)`` and ``(False)`` and read with
  :func:`take_spans`.  Each :class:`Span` carries its thread, its parent
  span on that thread and the call id of the ``match_many_async`` dispatch
  it belongs to, on any thread.  Times are ``time.perf_counter_ns()``;
* counters (:func:`count`, read with :func:`counts`), always on: the walks'
  work, the device-pairs search's template parts and candidates, blocking
  copies between host and card (:func:`to_device`, :func:`to_host`), and
  a mirror of the attribute counters
  (``host_sync.count``, each kernel wrapper's ``launches``).
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

_totals: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_trace: dict = {}

# the attribute counters counts() mirrors: (module, function, attribute)
_ATTRIBUTE_COUNTERS = (
    ("matching.optimize", "host_sync", "count"),
    ("ops.columns", "column_pass", "launches"),
    ("ops.minplus", "minplus_rows", "launches"),
    ("ops.minplus", "minplus_rows_wide", "launches"),
    ("ops.minplus", "far_pass", "launches"),
    ("ops.prop", "propagate_orientation", "launches"),
    ("ops.prop", "propagate_orientation", "any_launches"),
    ("ops.prop", "propagate_orientation_shared", "launches"),
    ("ops.prop", "propagate_orientation_global", "launches"),
    ("ops.integral", "sweep_stack", "launches"),
    ("ops.window", "tile_stack", "launches"),
    ("ops.window", "window_scores", "launches"),
    ("ops.window_v2", "window_v2", "launches"),
    ("ops.window_v3", "window_v3", "launches"),
    ("ops.walk", "decide_window", "launches"),
)
_counters: dict = dict.fromkeys(
    ("walks.windows", "walks.ext_candidates", "walks.lockstep_candidates",
     "copies.h2d", "copies.d2h", "search.template_parts", "search.candidates"), 0)

_recording = False
_spans: list = []
_ids = itertools.count(1)


class Span(NamedTuple):
    """One recorded span.  ``parent``: the id of the span open around it on
    its thread when it started (None at the top); ``call``: the id of the
    dispatch it belongs to (None outside one).  A ``serve.queue`` span's id
    is its request's id."""
    name: str
    start_ns: int
    end_ns: int
    thread: int               # threading.get_native_id()
    id: int
    parent: int | None
    call: int | None


class _ThreadState(threading.local):
    def __init__(self):
        self.stack = []           # ids of the spans open on this thread
        self.call = None          # the call id open on this thread
        self.thread = threading.get_native_id()   # a system call: read once


_tls = _ThreadState()


class _Off:
    """The context of a span or call while recording is off: nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _tls.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _tls.stack.pop()
        _spans.append((self.name, self.t0, t1, _tls.thread, self.id, self.parent,
                       _tls.call))
        return False


def span(name: str):
    """``with span(name):`` records the block as a :class:`Span` while
    recording is on; otherwise does nothing."""
    if not _recording:
        return _OFF
    return _Open(name)


class _Call:
    __slots__ = ("cid", "prev")

    def __init__(self, cid):
        self.cid = cid

    def __enter__(self):
        self.prev = _tls.call
        if self.cid is None:
            self.cid = self.prev if self.prev is not None else next(_ids)
        _tls.call = self.cid
        return self.cid

    def __exit__(self, *exc):
        _tls.call = self.prev
        return False


def call(cid: int | None = None):
    """``with call() as cid:`` makes the spans of the block, on this thread,
    carry call id ``cid``: a new id, or the one already open on the thread
    (a dispatch inside a service's dispatch is one call); ``call(cid)``
    reopens a given id (a dispatch's collect, on any thread).  None while
    recording is off."""
    if not _recording:
        return _OFF
    return _Call(cid)


def stamp() -> int | None:
    """``time.perf_counter_ns()`` while recording is on, else None: a start
    taken now for a span :func:`record` adds later."""
    return time.perf_counter_ns() if _recording else None


def record(name: str, start_ns: int, end_ns: int, call: int | None = None) -> None:
    """Add a span of given times on this thread (parent: the span open
    here now; ``call``: default the call open here now)."""
    stack = _tls.stack
    _spans.append((name, start_ns, end_ns, _tls.thread, next(_ids),
                   stack[-1] if stack else None, _tls.call if call is None else call))


def record_spans(on: bool = True) -> None:
    """Turn span recording on or off.  Spans stay in memory until
    :func:`take_spans`; nothing is written out."""
    global _recording
    _recording = bool(on)


def take_spans() -> list:
    """The spans recorded so far, in the order they ended; clears them."""
    global _spans
    out, _spans = _spans, []
    return [Span._make(s) for s in out]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (always on)."""
    _counters[name] = _counters.get(name, 0) + n


def counts() -> dict:
    """One snapshot of every counter: the attribute counters, read where
    they live (``host_sync.count``, ``<wrapper>.launches``), and those of
    :func:`count`.  Cumulative: take differences around a run."""
    out = {}
    for module, fn, attr in _ATTRIBUTE_COUNTERS:
        mod = importlib.import_module(f"{__package__}.{module}")
        out[f"{fn}.{attr}"] = getattr(getattr(mod, fn), attr)
    out.update(_counters)
    return out


def _on_card(device) -> bool:
    """Whether ``device`` is a card (None: torch's default, the host)."""
    return device is not None and torch.device(device).type != "cpu"


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype, device)``, counted in ``copies.h2d`` when
    it copies host data onto a card (a blocking copy from pageable
    memory)."""
    if _on_card(device) and not (torch.is_tensor(a) and _on_card(a.device)):
        count("copies.h2d")
    return torch.as_tensor(a, dtype=dtype, device=device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``, counted in ``copies.d2h`` when ``t`` is on a
    card."""
    if _on_card(t.device):
        count("copies.d2h")
    return t.cpu().numpy()


@contextlib.contextmanager
def stage(name: str, sync: bool = False):
    """Annotate and time a pipeline stage, and record it as a :func:`span`
    while recording is on.  ``sync=True`` waits for the card's queued work
    (when this process uses CUDA) before stopping the clock; otherwise the
    time covers the host side only."""
    t0 = time.perf_counter()
    with span(name):
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
    """Accumulates ``{stage: seconds}`` over calls.  The synchronize ending
    each stage is recorded as span ``timer.sync``."""

    def __init__(self):
        self.totals: dict = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, device):
        t0 = time.perf_counter()
        yield
        if torch.device(device).type == "cuda":
            with span("timer.sync"):
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
