"""Exact ties across every split of a search.  The bank holds each
template twice (template ``i`` and ``i + 3`` are equal), so their
candidates score equal bit for bit; each split puts the two copies on
either side of it: template parts, pair chunks, bank shards, mesh blocks
and sweep chunks.  Every path ranks the tied rows by the lower template and
candidate index (the rule ``lax.top_k`` sets) and equals its unsplit call
bit for bit."""
import numpy as np
import pytest
import torch

import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.matching import pipeline as tpipe
from openfdcm_tpu_torch.parallel import (global_topk, make_mesh,
                                         match_many_bank_sharded,
                                         topk_candidates)
from openfdcm_tpu_torch.sweep import resumable_sweep
from tests.torch_cases import assert_same_matches, three_scene_problem

torch.set_num_threads(1)

CPU = torch.device("cpu")
PARAMS = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
TOP_K = 12
PENALTY = ot.ExponentialPenalty(1.5)


class Subclass(ot.DefaultSearch):
    """A subclassed searcher: host pair tables, device top-k."""


def _problem():
    """Three scenes and the three templates twice over."""
    scenes, templates = three_scene_problem()
    return scenes, templates + [t.copy() for t in templates]


def _match_many(scenes, templates, searcher=None, top_k=TOP_K):
    return ot.match_many(scenes, templates, PARAMS,
                         searcher or ot.DefaultSearch(4, 10),
                         ot.BatchOptimize(10), penalty=PENALTY,
                         template_lengths=ot.get_template_lengths(templates),
                         top_k=top_k, device="cpu")


def _spy(monkeypatch, attr):
    calls = []
    fn = getattr(tpipe, attr)

    def spy(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)
    monkeypatch.setattr(tpipe, attr, spy)
    return calls


def _ties_in_order(per_scene) -> int:
    """Scores ascend and equal scores rank by the lower template first;
    the number of ties between two templates."""
    n = 0
    for rows in per_scene:
        for a, b in zip(rows, rows[1:]):
            assert a.score <= b.score
            if a.score == b.score:
                assert a.tmpl_idx <= b.tmpl_idx
                n += a.tmpl_idx != b.tmpl_idx
    return n


def _split(path, monkeypatch, tmp_path, scenes, templates):
    """``(split, whole)`` results of one path."""
    if path == "device-pairs-template-parts":
        whole = _match_many(scenes, templates)
        calls = _spy(monkeypatch, "_search_device_batch_topk_genpairs")
        monkeypatch.setattr(tpipe, "CPU_BUDGET", 1)   # a template a part
        split = _match_many(scenes, templates)
        assert len(calls) == len(scenes) * len(templates)
        return split, whole
    if path in ("host-pairs-pair-chunks", "host-ranking-no-top-k"):
        searcher, top_k = ((Subclass(4, 10), TOP_K) if path == "host-pairs-pair-chunks"
                           else (ot.DefaultSearch(4, 10), None))
        whole = _match_many(scenes, templates, searcher, top_k)
        calls = _spy(monkeypatch, "_search_device_batch_topk" if top_k
                     else "_search_device_batch")
        monkeypatch.setattr(tpipe, "CPU_BUDGET", 1)   # 64 pairs a part
        split = _match_many(scenes, templates, searcher, top_k)
        assert len(calls) > len(scenes)
        if top_k is None:
            # emplace order (template-major); a stable sort by score then
            # ranks the ties by template and candidate
            for rows in split:
                tmpl = [m.tmpl_idx for m in rows]
                assert tmpl == sorted(tmpl)
            return ([ot.sort_matches(r) for r in split],
                    [ot.sort_matches(r) for r in whole])
        return split, whole
    whole = _match_many(scenes, templates)
    if path == "bank-sharded":
        mesh = make_mesh((1, 2), ("scene", "bank"), devices=[CPU] * 2)
        split = match_many_bank_sharded(
            scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
            ot.BatchOptimize(10), mesh=mesh, top_k=TOP_K, penalty=PENALTY,
            template_lengths=ot.get_template_lengths(templates))
        return split, whole
    assert path == "sweep-chunks"
    split = resumable_sweep(
        scenes, templates, PARAMS, ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
        top_k=TOP_K, state_dir=str(tmp_path / "sweep"), penalty=PENALTY,
        template_lengths=ot.get_template_lengths(templates), chunk_size=3,
        device="cpu")
    return split, whole


def _global_topk_ties():
    """Scores whose every value lies in two of four mesh blocks."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 10, 16).astype(np.float32)
    scores = np.concatenate([base, base[::-1]])
    valid = np.ones(scores.shape, bool)
    valid[[2, 17]] = False
    mesh = make_mesh((4,), ("cand",), devices=[CPU] * 4)
    s, v = torch.as_tensor(scores), torch.as_tensor(valid)
    vals, idx = global_topk(mesh, s, v, TOP_K)
    whole = topk_candidates(s, v, TOP_K)
    assert torch.equal(vals, whole[0]) and torch.equal(idx, whole[1])
    masked = np.where(valid, scores, np.inf)
    np.testing.assert_array_equal(
        idx.numpy(), np.lexsort((np.arange(scores.size), masked))[:TOP_K])
    tied = vals[1:] == vals[:-1]
    assert bool(tied.any())
    assert bool((idx[1:][tied] > idx[:-1][tied]).all())


@pytest.mark.parametrize("path", [
    "device-pairs-template-parts", "host-pairs-pair-chunks",
    "host-ranking-no-top-k", "bank-sharded", "global-topk", "sweep-chunks"])
def test_ties_rank_by_lowest_index_across_splits(path, monkeypatch, tmp_path):
    if path == "global-topk":
        _global_topk_ties()
        return
    scenes, templates = _problem()
    split, whole = _split(path, monkeypatch, tmp_path, scenes, templates)
    assert assert_same_matches(split, whole, exact=True) > 0
    assert _ties_in_order(split) > 0
