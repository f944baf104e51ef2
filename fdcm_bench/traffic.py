"""The one load generator: closed-loop callers of the program's entry
points, driven by a traffic file's parameters.

Two kinds of traffic file exist:

- ``"kind": "batch"``: one caller runs passes back to back.  A pass is
  ``calls_per_pass`` calls of ``scenes_per_call`` scenes each, every call
  dispatched (``match_many_async``) before the first is collected, or one
  ``match_many`` a call.  With ``"bank": "per_object"`` call ``c`` of a
  pass takes the scenes of object ``c`` against that object's bank.
- ``"kind": "closed_loop"``: ``clients`` threads, each sending one scene
  and waiting for its answer before it sends the next, through
  ``match_many`` or a shared ``MatcherService`` (``"entry": "service"``).

The scenes come from the pool made in set-up, in pool order.  A driver
records every scene completed in the window with its answer and, for the
closed loop, its latency from submit to the answer's list of matches.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class Done:
    """A completed scene: its pool index, its bank, the answer, and where
    it ran: the index of its call in ``Record.calls`` and its slot there
    (batch traffic), or the client that sent it (closed loop)."""
    pool: int
    bank: int
    answer: list
    latency_s: float | None = None
    call: int = 0
    slot: int = 0
    client: int = 0


@dataclass
class Record:
    """What a window did."""
    start: float = 0.0
    end: float = 0.0
    done: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    calls: list = field(default_factory=list)     # scene lists sent, per call
    errors: list = field(default_factory=list)
    spans: list = field(default_factory=list)     # (name, start ns, end ns)

    def span(self, name):
        return Span(self, name)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Program:
    """The program's entry points with the configuration's settings."""

    def __init__(self, of, config, banks, device, timer=None):
        m = config["matching"]
        self.of = of
        self.params = of.Dt3Params(m["depth"], m["dt3_coeff"], m["padding"],
                                   of.Distance[m["distance"]])
        self.searcher = of.DefaultSearch(m["max_tmpl_lines"], m["max_scene_lines"])
        self.optimizer = of.BatchOptimize(m["batch_size"])
        self.penalty = of.ExponentialPenalty(m["penalty_tau"])
        self.top_k = m["top_k"]
        self.pad_to = m["pad_to"]
        self.banks = banks
        self.device = device
        self.timer = timer

    def kw(self):
        return dict(penalty=self.penalty, pad_to=self.pad_to, top_k=self.top_k,
                    device=self.device, timer=self.timer)

    def match_many(self, scenes, bank):
        return self.of.match_many(scenes, self.banks[bank], self.params,
                                  self.searcher, self.optimizer, **self.kw())

    def match_many_async(self, scenes, bank):
        return self.of.match_many_async(scenes, self.banks[bank], self.params,
                                        self.searcher, self.optimizer, **self.kw())

    def service(self, traffic):
        return self.of.MatcherService(
            self.banks[0], self.params, self.searcher, self.optimizer,
            top_k=self.top_k, penalty=self.penalty,
            max_batch=traffic["max_batch"],
            max_batch_delay_s=traffic["max_batch_delay_s"], device=self.device)


class Span:
    """The host's time in one of the benchmark's own calls, on
    ``time.perf_counter_ns`` (any thread), for naming the device's idle
    gaps."""

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.rec.spans.append((self.name, self.t0, time.perf_counter_ns()))


class Batch:
    """Passes of pipelined calls from one caller."""

    def __init__(self, traffic, program, inputs):
        self.t = traffic
        self.p = program
        self.per_object = traffic["bank"] == "per_object"
        n_calls = traffic["calls_per_pass"]
        if self.per_object:
            self.queues = [[i for i, b in enumerate(inputs.bank_of) if b == c]
                           for c in range(n_calls)]
        else:
            self.queues = [list(range(len(inputs.scenes)))] * n_calls
        self.scenes = inputs.scenes
        self.cursor = [0] * n_calls if self.per_object else [0]

    def _take(self, c):
        q = self.queues[c]
        k = c if self.per_object else 0
        n = self.t["scenes_per_call"]
        idx = [q[(self.cursor[k] + j) % len(q)] for j in range(n)]
        self.cursor[k] += n
        return idx

    def one_pass(self, rec: Record):
        calls = []
        for c in range(self.t["calls_per_pass"]):
            idx = self._take(c)
            bank = c if self.per_object else 0
            scenes = [self.scenes[i] for i in idx]
            call = len(rec.calls)
            rec.calls.append(scenes)
            rec.attempted += len(idx)
            try:
                if self.t["entry"] == "match_many_async":
                    with rec.span("dispatch"):
                        calls.append((call, idx, bank,
                                      self.p.match_many_async(scenes, bank)))
                else:
                    with rec.span("match_many"):
                        answers = self.p.match_many(scenes, bank)
                    calls.append((call, idx, bank, lambda a=answers: a))
            except Exception as exc:  # noqa: BLE001 - a failed call is counted
                rec.failed += len(idx)
                rec.errors.append(repr(exc))
        for call, idx, bank, collect in calls:
            try:
                with rec.span("collect"):
                    answers = collect()
            except Exception as exc:  # noqa: BLE001 - a failed call is counted
                rec.failed += len(idx)
                rec.errors.append(repr(exc))
                continue
            rec.done += [Done(i, bank, a, call=call, slot=j)
                         for j, (i, a) in enumerate(zip(idx, answers))]

    def run(self, seconds: float | None, passes: int = 1) -> Record:
        rec = Record(start=time.perf_counter())
        n = 0
        while (time.perf_counter() - rec.start < seconds) if seconds else n < passes:
            self.one_pass(rec)
            n += 1
        rec.end = time.perf_counter()
        return rec

    def close(self):
        pass


class ClosedLoop:
    """``clients`` threads, one scene in flight each."""

    def __init__(self, traffic, program, inputs):
        self.t = traffic
        self.p = program
        self.scenes = inputs.scenes
        self.svc = program.service(traffic) if traffic["entry"] == "service" else None
        self.cursor = 0
        self.lock = threading.Lock()

    def _next(self):
        with self.lock:
            i = self.cursor % len(self.scenes)
            self.cursor += 1
            return i

    def _call(self, scene):
        if self.svc is not None:
            return self.svc.submit(scene).result(timeout=300)
        return self.p.match_many([scene], 0)[0]

    def _client(self, client, rec, stop, rounds):
        n = 0
        while (time.perf_counter() < stop) if stop else n < rounds:
            n += 1
            i = self._next()
            t0 = time.perf_counter()
            try:
                with rec.span("request"):
                    answer = self._call(self.scenes[i])
            except Exception as exc:  # noqa: BLE001 - a failed request is counted
                with self.lock:
                    rec.attempted += 1
                    rec.failed += 1
                    rec.errors.append(repr(exc))
                continue
            t1 = time.perf_counter()
            with self.lock:
                rec.attempted += 1
                rec.calls.append([self.scenes[i]])
                rec.done.append(Done(i, 0, answer, t1 - t0, client=client))

    def run(self, seconds: float | None, rounds: int = 1) -> Record:
        rec = Record(start=time.perf_counter())
        stop = rec.start + seconds if seconds else None
        threads = [threading.Thread(target=self._client, args=(c, rec, stop, rounds),
                                    name=f"bench-client-{c}")
                   for c in range(self.t["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        rec.end = time.perf_counter()
        return rec

    def close(self):
        if self.svc is not None:
            self.svc.close()


DRIVERS = {"batch": Batch, "closed_loop": ClosedLoop}
