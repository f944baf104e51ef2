"""Reading a device-only ``torch.profiler`` trace of the measured window.

The profiler stamps device operations on the epoch clock
(``time.time_ns``); the harness gives the window on that clock and its own
host spans (:class:`.traffic.Span`, on ``time.perf_counter_ns``) shifted
onto it.  From the trace this takes the device's operations (kernels,
copies, sets), their union as the busy time, the idle gaps between them
named by the benchmark's host span the host was in, and the device time
of kernels by name.
"""
from __future__ import annotations

import re
from collections import defaultdict

import torch

SHORT_GAP_NS = 10_000


def _end(e) -> int:
    return e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()


class Trace:
    """Device operations ``(name, start, end)`` in ns within the window
    ``[lo, hi]``, and the host's spans, all on the epoch clock."""

    def __init__(self, prof, lo: int, hi: int, host_spans=()):
        cpu = torch.autograd.DeviceType.CPU
        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cpu or e.is_user_annotation():
                continue
            s, t = e.start_ns(), _end(e)
            if t > lo and s < hi:
                ops.append((e.name(), max(s, lo), min(t, hi)))
        self.lo, self.hi = lo, hi
        self.window_ns = hi - lo
        self.ops = ops
        self.spans = list(host_spans)
        self.busy = self._union()

    def _union(self):
        merged = []
        for _, s, t in sorted(self.ops, key=lambda o: o[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) / 1e9

    @property
    def window_s(self) -> float:
        return self.window_ns / 1e9

    def kernel_s(self, names) -> float | None:
        """Device seconds of the operations whose name holds one of
        ``names``; None when none ran."""
        hits = [t - s for n, s, t in self.ops if any(k in n for k in names)]
        return sum(hits) / 1e9 if hits else None

    def device_ops(self, top=10):
        by = defaultdict(int)
        for n, s, t in self.ops:
            by[short(n)] += t - s
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """Idle time between device operations inside the window, summed by
        the innermost bench span the host was in at each gap's middle."""
        edges = [self.lo] + [t for _, t in self.busy]
        starts = [s for s, _ in self.busy] + [self.hi]
        by = defaultdict(int)
        spans = sorted(self.spans, key=lambda x: x[1])
        active, j = [], 0
        for a, b in zip(edges, starts):       # in time order
            if b <= a:
                continue
            if b - a < SHORT_GAP_NS:
                by["gaps_under_10_us"] += b - a
                continue
            mid = (a + b) // 2
            while j < len(spans) and spans[j][1] <= mid:
                active.append(spans[j])
                j += 1
            active = [sp for sp in active if sp[2] > mid]
            name = min(active, key=lambda sp: sp[2] - sp[1])[0] if active else "outside_bench_spans"
            by[name] += b - a
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def short(name: str, n: int = 96) -> str:
    return re.sub(r"\s+", " ", name)[:n]
