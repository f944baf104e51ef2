"""``parallel.initialize`` joins a ``torch.distributed`` group: two spawned
gloo ranks, their rendezvous a file under the test's own directory (so
parallel test workers never share a port), reach world size 2 and run one
``all_gather``."""
import json
import time

import pytest
import torch
import torch.multiprocessing as mp

from openfdcm_tpu_torch.parallel import distributed
from tests import torch_dist_worker


def test_initialize_joins_a_two_rank_gloo_group(tmp_path):
    if not torch.distributed.is_available():
        pytest.skip("torch.distributed is not built in")
    ranks = mp.spawn(torch_dist_worker.run,
                     args=(2, str(tmp_path / "rendezvous"), str(tmp_path)),
                     nprocs=2, join=False)
    deadline = time.monotonic() + 120
    while not ranks.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            pytest.fail("the two ranks did not finish within 120 s")
    for rank in range(2):
        seen = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert seen == dict(rank=rank, world=2, gathered=[1, 2], jax=[])


def test_initialize_passes_every_argument(monkeypatch, tmp_path):
    """A bare ``host:port`` is taken as TCP; the backend, world size and
    rank go to ``init_process_group`` as given."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    distributed.initialize("localhost:29555", 4, 3, backend="gloo")
    distributed.initialize(f"file://{tmp_path}/r", 2, 0)
    assert calls == [
        (("gloo",), dict(init_method="tcp://localhost:29555", world_size=4,
                         rank=3)),
        (("nccl",), dict(init_method=f"file://{tmp_path}/r", world_size=2,
                         rank=0)),
    ]
