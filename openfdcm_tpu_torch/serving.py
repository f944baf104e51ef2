"""Serving: a warm, bank-resident matcher with micro-batching (port of
:mod:`openfdcm_tpu.serving`).

:class:`MatcherService` keeps one template bank on its device and batches
concurrent requests into ``match_many`` dispatches:

- ``submit(scene) -> Future`` from any thread; one dispatch thread collects
  requests for up to ``max_batch_delay_s`` (or until ``max_batch`` scenes
  wait) and runs them through one ``match_many(..., device=device)`` call,
  with results identical to calling it directly;
- ``warmup(example_scenes)`` runs the shapes a deployment expects before
  the first request (the kernels' build and the first launches).

A batch that raises fails its requests' futures; nothing is retried on
another device.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from . import profiling
from .matching import featuremap as fm
from .matching.match import TemplateBank, _bank_on
from .matching.pipeline import _call_device, match_many

__all__ = ["MatcherService"]


class MatcherService:
    """A long-lived matching service around a fixed template bank on
    ``device`` (default the card; a given :class:`TemplateBank` must be on
    it).  Parameters mirror :func:`openfdcm_tpu_torch.match_many`;
    ``top_k`` is required (serving returns ranked results).  ``mesh``: an
    optional :class:`~openfdcm_tpu_torch.parallel.Mesh` every batch runs on
    (``match_many(..., mesh=mesh)``); it decides ``device`` when that is
    None."""

    def __init__(self, templates, params: fm.Dt3Params, searcher, optimizer,
                 *, top_k: int, penalty=None, template_lengths=None,
                 mesh=None, max_batch: int = 16,
                 max_batch_delay_s: float = 0.005, device=None):
        self.device = _call_device(mesh, device, "MatcherService")
        self.mesh = mesh
        self.bank: TemplateBank = _bank_on(templates, self.device, "service")
        self.params = params
        self.searcher = searcher
        self.optimizer = optimizer
        self.top_k = top_k
        self.penalty = penalty
        self.template_lengths = template_lengths
        self.max_batch = max_batch
        self.max_batch_delay_s = max_batch_delay_s
        self.dispatches = 0
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="openfdcm-matcher")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, scene) -> Future:
        """Enqueue one scene; resolves to ``list[Match]`` (k best,
        ascending score)."""
        if self._closed.is_set():
            raise RuntimeError("MatcherService is closed")
        fut: Future = Future()
        self._queue.put((np.asarray(scene, np.float32), fut, profiling.stamp()))
        return fut

    def match(self, scene, timeout: float | None = None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(scene).result(timeout)

    def warmup(self, example_scenes) -> None:
        """Run the given scenes once, so that the first requests pay no
        build or first-launch cost."""
        futs = [self.submit(s) for s in example_scenes]
        for f in futs:
            f.result()

    def close(self) -> None:
        self._closed.set()
        self._queue.put(None)           # wake the dispatcher
        self._thread.join(timeout=30)
        # fail any request that raced the shutdown instead of dropping it
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].cancelled():
                item[1].set_exception(RuntimeError("MatcherService closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _collect(self):
        """Block for one request, then drain more until the batch window
        closes or ``max_batch`` is reached.  Returns the batch and the
        window's start (:func:`~.profiling.stamp`)."""
        first = self._queue.get()
        if first is None:
            return None, None
        t_window = profiling.stamp()
        batch = [first]
        t_end = time.monotonic() + max(self.max_batch_delay_s, 0.0)
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            try:
                # zero delay still drains whatever is already queued:
                # concurrent submitters coalesce, a lone request never waits
                item = (self._queue.get_nowait() if remaining <= 0
                        else self._queue.get(timeout=remaining))
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)   # re-signal close after this batch
                break
            batch.append(item)
        return batch, t_window

    def _loop(self):
        # the dispatch thread's CUDA work runs on the service's card
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            while not self._closed.is_set():
                batch, t_window = self._collect()
                if batch is None:
                    return
                with profiling.call() as cid:
                    if cid is not None:
                        self._record_waits(batch, t_window, cid)
                    with profiling.span("serve.dispatch"):
                        self._dispatch(batch)

    @staticmethod
    def _record_waits(batch, t_window, cid) -> None:
        """Spans ``serve.window`` (the batch window after the first
        request) and, per request, ``serve.queue`` (its submit to the start
        of this dispatch; the span's id is the request's), on call ``cid``."""
        now = time.perf_counter_ns()
        if t_window is not None:
            profiling.record("serve.window", t_window, now, cid)
        for item in batch:
            if item[2] is not None:
                profiling.record("serve.queue", item[2], now, cid)

    def _dispatch(self, batch) -> None:
        futs = [item[1] for item in batch]
        try:
            results = match_many(
                [item[0] for item in batch], self.bank, self.params, self.searcher,
                self.optimizer, penalty=self.penalty,
                template_lengths=self.template_lengths, top_k=self.top_k,
                device=self.device, mesh=self.mesh)
        except Exception as exc:  # noqa: BLE001 — fail the whole batch
            for f in futs:
                if not f.cancelled():
                    f.set_exception(exc)
            return
        finally:
            self.dispatches += 1
        for f, r in zip(futs, results):
            if not f.cancelled():
                f.set_result(r)
