"""Per-stage wall time of the pipeline (port of :mod:`openfdcm_tpu.profiling`).

A :class:`StageTimer` is created by the caller and passed to
``match_many(..., timer=...)``; each stage ends with a device synchronize so
its time covers the device work, not only the launches.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
