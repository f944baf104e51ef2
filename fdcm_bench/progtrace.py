"""The device trace charged to the program's own spans.

:class:`ProgramTrace` is a :class:`~.devtrace.Trace` that also holds the
spans ``openfdcm_tpu_torch.profiling`` recorded in the window (shifted onto
the trace's epoch clock by the same anchor as the benchmark's spans) and:

- names the idle gaps by them, under the rule it inherits: the innermost
  span open at a gap's middle, on any thread;
- charges each device operation to the innermost program span open when
  it was launched.  The launch is the CUDA runtime event
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that shares the
  operation's correlation id.  A device-only trace does not say which
  thread launched it (its runtime events carry thread id 1 and the
  process id as device index), so the span is the shortest open then on
  any thread: exact while one thread at a time runs the program, as in
  every cell (the caller's thread, or a service's dispatch thread).

Spans that record a wait rather than what a thread was doing
(``serve.queue``: a request's time from submit to its dispatch, recorded
on the dispatch thread) name no gap and are charged nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from .devtrace import Trace

WAITS = ("serve.queue",)
OUTSIDE = "outside_program_spans"


def shifted(spans, offset: int) -> list:
    """Program spans ``(name, start, end, thread, id, parent, call)`` moved
    by ``offset`` ns (the epoch clock minus ``time.perf_counter_ns``)."""
    return [(s[0], s[1] + offset, s[2] + offset, *s[3:7]) for s in spans]


def innermost(spans) -> list:
    """Disjoint ``(start, end, name, length)`` segments of one thread's
    nested spans ``(name, start, end)``, each named by the innermost span
    open there (``length``: that span's), in time order."""
    segs, stack, t = [], [], None

    def upto(x):
        nonlocal t
        if stack and t is not None and x > t:
            top = stack[-1]
            segs.append((t, x, top[0], top[2] - top[1]))
        t = x if t is None else max(t, x)

    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][2] <= s:
            upto(stack[-1][2])
            stack.pop()
        upto(s)
        stack.append((name, s, e))
    while stack:
        upto(stack[-1][2])
        stack.pop()
    return segs


class ProgramTrace(Trace):
    """``Trace(prof, lo, hi, host_spans)`` plus the program's spans
    (already on the epoch clock, :func:`shifted`)."""

    def __init__(self, prof, lo: int, hi: int, host_spans=(), program_spans=()):
        self.program_spans = list(program_spans)
        named = [(s[0], s[1], s[2]) for s in self.program_spans if s[0] not in WAITS]
        super().__init__(prof, lo, hi, [*host_spans, *named])
        cpu = torch.autograd.DeviceType.CPU
        launches, ops = {}, []
        for e in prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            corr = e.correlation_id()
            if e.device_type() == cpu:
                if corr:
                    launches[corr] = e.start_ns()
                continue
            s, t = e.start_ns(), e.end_ns() if hasattr(e, "end_ns") else \
                e.start_ns() + e.duration_ns()
            if t > lo and s < hi:
                ops.append((e.name(), min(t, hi) - max(s, lo), corr))
        by_thread = defaultdict(list)
        for s in self.program_spans:
            if s[0] not in WAITS:
                by_thread[s[3]].append((s[0], s[1], s[2]))
        self._segs = {th: innermost(sp) for th, sp in by_thread.items()}
        self._starts = {th: [g[0] for g in sg] for th, sg in self._segs.items()}
        # (device op name, ns, program span it is charged to)
        self.charged = []
        self.unlaunched = 0
        for name, ns, corr in ops:
            x = launches.get(corr)
            if x is None:
                self.unlaunched += 1
            seg = None if x is None else min(
                filter(None, (self._open(th, x) for th in self._segs)),
                key=lambda g: g[3], default=None)
            self.charged.append((name, ns, seg[2] if seg else OUTSIDE))

    def _open(self, thread, x):
        """The segment of ``thread`` open at ``x``, or None."""
        k = bisect.bisect_right(self._starts[thread], x) - 1
        seg = self._segs[thread][k] if k >= 0 else None
        return seg if seg and seg[0] <= x < seg[1] else None

    def charge(self) -> dict:
        """Device seconds charged to each program span name."""
        by = defaultdict(int)
        for _, ns, owner in self.charged:
            by[owner] += ns
        return {k: v / 1e9 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}

    def charge_of(self, kernels) -> dict:
        """For the operations whose name holds one of ``kernels``: device
        seconds charged to each program span name."""
        by = defaultdict(int)
        for name, ns, owner in self.charged:
            if any(k in name for k in kernels):
                by[owner] += ns
        return {k: v / 1e9 for k, v in by.items()}

    def idle_by_prefix(self, prefix: str) -> float:
        """Idle seconds of the gaps named by a program span whose name
        starts with ``prefix``."""
        return sum(s for n, s in self.idle_gaps(top=None) if n.startswith(prefix))
