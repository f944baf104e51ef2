"""The port's MatcherService on the CPU (``device="cpu"``): served results
equal direct ``match_many`` calls exactly; mirrors ``tests/test_serving.py``."""
import threading

import numpy as np
import pytest
import torch

import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.serving import MatcherService
from tests.test_serving import _setup
from tests.torch_cases import assert_same_matches

torch.set_num_threads(1)

PARAMS = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
DEV = dict(device="cpu")


def _direct(scenes, templates, **kw):
    return ot.match_many(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                         ot.BatchOptimize(10), **DEV, **kw)


def test_service_matches_direct_calls():
    templates, scenes = _setup()
    lengths = ot.get_template_lengths(templates)
    kw = dict(top_k=4, penalty=ot.ExponentialPenalty(1.5), template_lengths=lengths)
    direct = _direct(scenes, templates, **kw)
    with MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), max_batch_delay_s=0.05, **kw,
                        **DEV) as svc:
        futs = [svc.submit(s) for s in scenes]
        served = [f.result(timeout=600) for f in futs]
        assert svc.dispatches >= 1
    assert all(len(s) > 0 for s in served)
    assert assert_same_matches(served, direct, exact=True) > 0


def test_service_concurrent_submitters():
    templates, scenes = _setup(n_scenes=6)
    results = [None] * len(scenes)
    with MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), top_k=3, max_batch_delay_s=0.05,
                        **DEV) as svc:
        svc.warmup(scenes[:1])

        def worker(i):
            results[i] = svc.match(scenes[i], timeout=600)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(scenes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert all(r is not None and len(r) > 0 for r in results)
    assert_same_matches(results, _direct(scenes, templates, top_k=3), exact=True)


def test_service_close_rejects_new_work():
    templates, scenes = _setup(n_scenes=1)
    svc = MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                         ot.BatchOptimize(10), top_k=2, **DEV)
    assert len(svc.match(scenes[0], timeout=600)) > 0
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(scenes[0])


def test_service_zero_delay_dispatches_immediately():
    """``max_batch_delay_s=0`` dispatches a lone request without waiting for
    ``max_batch`` scenes."""
    templates, scenes = _setup(n_scenes=1)
    with MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), top_k=3, max_batch=16,
                        max_batch_delay_s=0.0, **DEV) as svc:
        res = svc.match(scenes[0], timeout=600)
    assert len(res) > 0


def test_service_close_fails_raced_requests():
    templates, scenes = _setup(n_scenes=1)
    svc = MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                         ot.BatchOptimize(10), top_k=3, **DEV)
    svc.match(scenes[0], timeout=600)       # warm once
    # a request that lands after the close marker can never be dispatched;
    # close() must fail it rather than drop it
    svc._closed.set()
    svc._queue.put(None)
    fut = ot.serving.Future()
    svc._queue.put((np.asarray(scenes[0], np.float32), fut))
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)


def test_failed_batch_fails_its_futures():
    """A batch that raises fails its requests; the service keeps serving."""
    templates, scenes = _setup(n_scenes=2)
    with MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), top_k=3,
                        penalty=ot.ExponentialPenalty(1.5),
                        template_lengths=[1.0], **DEV) as svc:
        with pytest.raises(IndexError):
            svc.match(scenes[0], timeout=600)
        svc.template_lengths = None
        assert len(svc.match(scenes[1], timeout=600)) > 0


def test_service_needs_cuda_unless_given_cpu(monkeypatch):
    templates, _ = _setup(n_scenes=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                       ot.BatchOptimize(10), top_k=3)
    bank = ot.prepare_templates(templates, **DEV)
    with MatcherService(bank, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), top_k=3, **DEV) as svc:
        assert svc.bank is bank


def test_service_on_a_scene_mesh():
    """``MatcherService(mesh=...)`` runs every batch on the mesh (four
    ``cpu`` entries) and serves the direct unsharded rows."""
    from openfdcm_tpu_torch.parallel import make_mesh
    templates, scenes = _setup(n_scenes=5)
    lengths = ot.get_template_lengths(templates)
    kw = dict(top_k=4, penalty=ot.ExponentialPenalty(1.5), template_lengths=lengths)
    mesh = make_mesh((4,), ("scene",), devices=[torch.device("cpu")] * 4)
    with MatcherService(templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), max_batch_delay_s=0.05,
                        mesh=mesh, **kw) as svc:
        assert svc.device == torch.device("cpu") and svc.mesh is mesh
        served = [f.result(timeout=600) for f in [svc.submit(s) for s in scenes]]
    assert assert_same_matches(served, _direct(scenes, templates, **kw),
                               exact=True) > 0
