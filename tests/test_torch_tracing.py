"""The port's spans and counters (``openfdcm_tpu_torch.profiling``) on the
CPU: the span names of one ``match_many`` and of a ``MatcherService``
dispatch, each with its parent and call id; nothing recorded while
recording is off, and the same results either way; the walks' counters
against the rule that rebuilds them from the values of the walks' host
syncs; the copy counters, and the counters of a dispatch's template
parts.  One ``gpu`` test charges the DT3 build's kernels to their spans in
a device trace.  Imports no JAX, so it also runs on a
card's host (``--noconftest``)."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch import profiling
from openfdcm_tpu_torch.matching import optimize as topt
from openfdcm_tpu_torch.matching import optimize_kernel as tok
from openfdcm_tpu_torch.matching import pipeline as tpipe
from openfdcm_tpu_torch.serving import MatcherService

torch.set_num_threads(1)

PARAMS = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
KW = dict(top_k=4, penalty=ot.ExponentialPenalty(1.5))

# span -> the span open around it in one match_many on the device pairs
PARENTS = {
    "match.call": None, "match.prepare": "match.call",
    "build.host": "match.call", "build.seed": "match.call",
    "build.columns": "match.call", "build.mask": "match.call",
    "build.relax": "match.call", "build.integral": "match.call",
    "bank.tables": ("match.prepare", "search.host"),
    "search.host": "match.call", "search.launch": "match.call",
    "search.topk": "search.launch", "walks.straggler": "search.launch",
    "walks.loop": "walks.straggler", "walks.sync": ("walks.straggler", "walks.loop"),
    "collect.copy": None, "collect.rows": None, "collect.match": None,
}


def _problem(n_tmpl=6, n_scenes=4, seed=3):
    """Templates of 4-7 lines and scenes made of a rotated, shifted
    template plus a few clutter lines."""
    rng = np.random.default_rng(seed)
    templates = []
    for i in range(n_tmpl):
        p = rng.uniform(0, 50 + 8 * (i % 3), (4 + i % 4, 2))
        q = p + rng.uniform(-20, 20, p.shape)
        templates.append(np.concatenate([p, q], axis=1).astype(np.float32))
    scenes = []
    for j in range(n_scenes):
        c, s = np.cos(0.21 * j), np.sin(0.21 * j)
        rot = np.array([[c, -s], [s, c]], np.float32)
        t = templates[j % n_tmpl]
        moved = np.concatenate([t[:, :2] @ rot.T, t[:, 2:] @ rot.T], axis=1) + 6.0 + j
        clutter = rng.uniform(0, 80, (3, 4)).astype(np.float32)
        scenes.append(np.concatenate([moved, clutter]).astype(np.float32))
    return templates, scenes


def _match(templates, scenes, **kw):
    return ot.match_many(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                         ot.BatchOptimize(10), device="cpu", **KW, **kw)


def _recorded(fn):
    profiling.take_spans()
    profiling.record_spans(True)
    try:
        out = fn()
    finally:
        profiling.record_spans(False)
    return out, profiling.take_spans()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert [(m.tmpl_idx, m.score) for m in x] == [(m.tmpl_idx, m.score) for m in y]
        for m, n in zip(x, y):
            np.testing.assert_array_equal(m.transform, n.transform)


def test_one_match_many_records_every_span(monkeypatch):
    """Every span name of the device-pairs path, each under its parent, all
    on one call id; walks forced out of a 2-step covered window so the
    lockstep walks run."""
    monkeypatch.setattr(tok, "TC", 2)
    templates, scenes = _problem()
    _, spans = _recorded(lambda: _match(templates, scenes))
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} == set(PARENTS)
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        want = PARENTS[s.name]
        assert parent in (want if isinstance(want, tuple) else (want,)), (s.name, parent)
        assert s.start_ns <= s.end_ns and s.thread == threading.get_native_id()
    assert len({s.call for s in spans}) == 1 and spans[0].call is not None
    call = next(s for s in spans if s.name == "match.call")
    inside = [s for s in spans if not s.name.startswith("collect.")]
    assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns for s in inside)


def test_service_queue_spans_carry_their_dispatch():
    """Two concurrent requests: one ``serve.queue`` span each, recorded on
    the dispatch thread from its submit to the start of the dispatch that
    served it, on that dispatch's call id."""
    templates, scenes = _problem(n_scenes=2)
    with MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
                        max_batch_delay_s=0.5, device="cpu", **KW) as svc:
        svc.warmup(scenes[:1])
        profiling.take_spans()
        profiling.record_spans(True)
        try:
            futs = [svc.submit(s) for s in scenes]
            served = [f.result(timeout=600) for f in futs]
        finally:
            profiling.record_spans(False)
        spans = profiling.take_spans()
    _same(served, _match(templates, scenes))
    queue = [s for s in spans if s.name == "serve.queue"]
    dispatch = [s for s in spans if s.name == "serve.dispatch"]
    window = [s for s in spans if s.name == "serve.window"]
    assert len(queue) == 2 and len(dispatch) == 1 and len(window) == 1
    d = dispatch[0]
    calls = {s.call for s in spans if s.name in ("match.call", "collect.match")}
    assert calls == {d.call} and all(q.call == d.call for q in queue + window)
    assert all(q.end_ns <= d.start_ns and q.thread == d.thread for q in queue)
    assert window[0].end_ns <= d.start_ns and len({q.id for q in queue}) == 2


def test_recording_off_records_nothing(monkeypatch):
    """Off: ``span`` hands back one shared no-op context (no allocation),
    reads no clock, and nothing is recorded; ``stage`` records a span only
    while recording is on."""
    templates, scenes = _problem(n_scenes=2)
    profiling.take_spans()
    assert profiling.span("match.call") is profiling.span("walks.sync")
    assert profiling.call() is profiling.span("x") and profiling.stamp() is None

    def no_clock():
        raise AssertionError("a clock was read")
    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    with profiling.span("walks.sync"), profiling.call():
        pass
    monkeypatch.undo()
    _match(templates, scenes)
    with profiling.stage("unit-test-stage"):
        pass
    assert profiling.take_spans() == []
    profiling.record_spans(True)
    with profiling.stage("unit-test-stage"):
        pass
    profiling.record_spans(False)
    assert [s.name for s in profiling.take_spans()] == ["unit-test-stage"]


def test_results_identical_with_recording_on_and_off(monkeypatch):
    monkeypatch.setattr(tok, "TC", 2)
    templates, scenes = _problem()
    off = _match(templates, scenes)
    on, spans = _recorded(lambda: _match(templates, scenes))
    assert spans
    _same(on, off)


def _straggler_rule(values):
    """The work counts rebuilt from the values the walks' host syncs read,
    in order: the live count before each extension pass, the live count
    entering a lockstep walk after a non-empty one, and the true any-live
    reads (one lockstep window each)."""
    ext_in = walk_in = windows = 0
    after_ext = False
    for v in values:
        if isinstance(v, bool):
            windows += v
        elif after_ext:
            walk_in, after_ext = walk_in + v, False
        else:
            ext_in, after_ext = ext_in + v, v > 0
    return {"walks.ext_candidates": ext_in, "walks.lockstep_candidates": walk_in,
            "walks.windows": windows}


@pytest.mark.parametrize("mode", ["batch", "default"])
def test_walk_counters_follow_the_sync_values(monkeypatch, mode):
    monkeypatch.setattr(tok, "TC", 2)
    real, values = topt.host_sync, []

    def logged(t):
        values.append(real(t))
        return values[-1]
    logged.count = real.count
    monkeypatch.setattr(topt, "host_sync", logged)
    templates, scenes = _problem()
    optimizer = ot.BatchOptimize(10) if mode == "batch" else ot.DefaultOptimize()
    before = profiling.counts()
    ot.match_many(scenes, templates, PARAMS, ot.DefaultSearch(4, 10), optimizer,
                  device="cpu", **KW)
    after = profiling.counts()
    real.count = logged.count
    want = _straggler_rule(values)
    assert want["walks.windows"] > 0 and want["walks.lockstep_candidates"] > 0
    assert {k: after[k] - before[k] for k in want} == want
    assert after["host_sync.count"] - before["host_sync.count"] == len(values)


def test_counts_mirror_the_attribute_counters():
    from openfdcm_tpu_torch.ops import minplus, prop, walk
    c = profiling.counts()
    assert c["host_sync.count"] == topt.host_sync.count
    assert c["minplus_rows.launches"] == minplus.minplus_rows.launches
    assert c["decide_window.launches"] == walk.decide_window.launches
    assert c["propagate_orientation.any_launches"] == prop.propagate_orientation.any_launches
    assert {"walks.windows", "walks.ext_candidates", "walks.lockstep_candidates",
            "copies.h2d", "copies.d2h"} <= set(c)
    profiling.count("walks.windows", 3)
    assert profiling.counts()["walks.windows"] == c["walks.windows"] + 3


class _CardTensor:
    """A stand-in for a tensor on a card: a ``device`` that is not the host
    and a ``cpu()`` that copies it."""
    device = torch.device("meta")

    def cpu(self):
        return torch.zeros(3)


def test_copy_helper_counts_host_card_copies_only():
    host = np.arange(6, dtype=np.float32)
    c0 = profiling.counts()

    def moved():
        c = profiling.counts()
        return c["copies.h2d"] - c0["copies.h2d"], c["copies.d2h"] - c0["copies.d2h"]
    assert profiling.to_device(host, "cpu").device.type == "cpu" and moved() == (0, 0)
    assert profiling.to_device(host, None).device.type == "cpu" and moved() == (0, 0)
    profiling.to_host(torch.ones(2))
    assert moved() == (0, 0)
    meta = profiling.to_device(host, "meta", torch.float32)
    assert meta.device.type == "meta" and meta.dtype == torch.float32
    assert moved() == (1, 0)
    profiling.to_device(meta, torch.device("meta"))          # already there
    profiling.to_device(torch.ones(2), "meta")               # a host tensor
    assert moved() == (2, 0)
    np.testing.assert_array_equal(profiling.to_host(_CardTensor()), np.zeros(3))
    assert moved() == (2, 1)


def test_template_part_counters_and_dispatch_copies(monkeypatch):
    """``search.template_parts`` and ``search.candidates`` count the template
    parts and candidates a dispatch searched.  Its host-to-card copies grow
    by one a part (the scenes' tables go once a dispatch), and the bank's second dispatch copies 4 fewer: the 3 search tables and the
    penalty's template lengths stay with the bank.  The host counts as a
    card here, so each copy of host data is counted."""
    monkeypatch.setattr(profiling, "_on_card", lambda device: device is not None)
    templates, scenes = _problem()
    parts = []
    real = tpipe._search_device_batch_topk_genpairs

    def spy(*a, **k):
        parts.append(a[5].shape[0] * 2 * a[3].shape[0] * a[3].shape[1] * k["ms"])
        return real(*a, **k)
    monkeypatch.setattr(tpipe, "_search_device_batch_topk_genpairs", spy)

    def dispatch(bank):
        parts.clear()
        c0 = profiling.counts()
        out = _match(bank, scenes)
        c1 = profiling.counts()
        return out, {k: c1[k] - c0[k]
                     for k in ("search.template_parts", "search.candidates", "copies.h2d")}
    bank = ot.prepare_templates(templates, device="cpu")
    _, first = dispatch(bank)
    whole, one = dispatch(bank)
    assert first["copies.h2d"] - one["copies.h2d"] == 4
    assert one["search.template_parts"] == len(parts) == 2     # the scenes' 2 canvas buckets
    assert one["search.candidates"] == sum(parts) == len(scenes) * 2 * len(templates) * 4 * 10
    monkeypatch.setattr(tpipe, "CPU_BUDGET", 1)       # a scene a chunk, a template a part
    split, many = dispatch(bank)
    assert many["search.template_parts"] == len(parts) == len(scenes) * len(templates)
    assert many["search.candidates"] == sum(parts) == one["search.candidates"]
    # one copy a part is left: the orientation splits of ``classify_lines``
    assert (many["copies.h2d"] - one["copies.h2d"]
            == many["search.template_parts"] - one["search.template_parts"])
    _same(split, whole)


@pytest.mark.gpu
def test_build_kernels_charged_to_their_spans():
    """In a traced build on the card, at least 99 % of the device time of
    K2's envelope, K3 and K4 is charged to ``build.columns``,
    ``build.relax`` and ``build.integral``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from fdcm_bench.progtrace import ProgramTrace, shifted
    _, scenes = _problem(n_scenes=3)
    params = ot.Dt3Params(30, 5.0, 1.0, ot.Distance.L2)
    ot.build_featuremap_batch(scenes, params, device="cuda")       # warm
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    epoch0, perf0 = time.time_ns(), time.perf_counter_ns()
    _, spans = _recorded(lambda: [ot.build_featuremap_batch(scenes, params, device="cuda")
                                  for _ in range(3)])
    torch.cuda.synchronize()
    epoch1 = time.time_ns()
    prof.stop()
    trace = ProgramTrace(prof, epoch0, epoch1, (), shifted(spans, epoch0 - perf0))
    for kernel, owner in (("edt_rows_kernel", "build.columns"),
                          ("prop_fixed", "build.relax"),
                          ("sweep_paths_kernel", "build.integral")):
        charged = trace.charge_of([kernel])
        assert sum(charged.values()) > 0, kernel
        assert charged.get(owner, 0.0) >= 0.99 * sum(charged.values()), (kernel, charged)
