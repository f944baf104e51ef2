"""A bank searched in template parts, and the tables the bank keeps.

The T-LESS bin-picking bank of the benchmark
(``fdcm_bench/configs/tless_primesense.json``: 30 objects, view templates of
23-33 lines) shrunk to CPU size, 30 x 6 templates against scenes of at most
256 px, with the device budget forced down so that one ``match_many`` call
searches it in three or more template parts.  Its top-10 rows equal the
benchmark's plain reference (``fdcm_bench/reference.py``) and, bit for bit,
the same call in one part.  The bank's search tables and template lengths
are made once per bank and ``max_tmpl_lines``, equal to the tables a
dispatch used to build on every call.  Imports no JAX."""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import openfdcm_tpu_torch as ot  # noqa: E402
from fdcm_bench import compare, reference, workload  # noqa: E402
from openfdcm_tpu_torch.matching import featuremap as tfm  # noqa: E402
from openfdcm_tpu_torch.matching import pipeline as tpipe  # noqa: E402

torch.set_num_threads(1)

TOP_K = 10


def _config():
    with open(os.path.join(ROOT, "fdcm_bench", "configs", "tless_primesense.json")) as f:
        config = json.load(f)
    config["inputs"].update(templates_per_bank=6, template_half_extent_px=40.0,
                            line_length_px=[10.0, 60.0], scene_extent_px=250.0,
                            template_reach_px=100.0, clutter_lines=40,
                            clutter_margin_px=30.0)
    return config


CONFIG = _config()
M = CONFIG["matching"]
PARAMS = ot.Dt3Params(M["depth"], M["dt3_coeff"], M["padding"], ot.Distance[M["distance"]])
SEARCH = ot.DefaultSearch(M["max_tmpl_lines"], M["max_scene_lines"])


def _inputs(seed=2 ** 31 + 7, pool=2):
    return workload.make_inputs(CONFIG, seed, pool)


def _match(scenes, bank, searcher=SEARCH):
    return ot.match_many(scenes, bank, PARAMS, searcher, ot.BatchOptimize(M["batch_size"]),
                         penalty=ot.ExponentialPenalty(M["penalty_tau"]), top_k=TOP_K,
                         pad_to=M["pad_to"], device="cpu")


def _parts_budget(scenes, n_templates, parts):
    """A ``CPU_BUDGET`` that holds one scene's tiled stack and the
    candidates of ``n_templates / parts`` templates."""
    side = max(max(wh) for _, wh in (tfm.scene_centered_translation(s, M["padding"])
                                     for s in scenes))
    side = -(-side // M["pad_to"]) * M["pad_to"]
    per_template = 2 * M["max_tmpl_lines"] * M["max_scene_lines"] * tpipe._cand_bytes(33)
    return (tpipe._tile_bytes((M["depth"], side, side))
            + per_template * -(-n_templates // parts))


def _rows(answer):
    return [[(m.tmpl_idx, m.score, m.transform.tobytes()) for m in scene] for scene in answer]


def test_the_bank_is_the_shrunken_tless_bank():
    inputs = _inputs()
    assert len(inputs.banks) == 30 and {len(b) for b in inputs.banks} == {6}
    assert all(23 <= t.shape[0] <= 33 for t in inputs.whole_bank())
    for s in inputs.scenes:
        _, (w, h) = tfm.scene_centered_translation(s, M["padding"])
        assert max(w, h) <= 256


def test_template_parts_equal_the_reference_and_one_part(monkeypatch):
    inputs = _inputs()
    templates = inputs.whole_bank()
    bank = ot.prepare_templates(templates, device="cpu")
    whole = _match(inputs.scenes, bank)

    calls = []
    real = tpipe._search_device_batch_topk_genpairs
    monkeypatch.setattr(tpipe, "_search_device_batch_topk_genpairs",
                        lambda *a, **k: calls.append(a[3].shape[0]) or real(*a, **k))
    monkeypatch.setattr(tpipe, "CPU_BUDGET", _parts_budget(inputs.scenes, len(templates), 3))
    split = _match(inputs.scenes, bank)
    # a scene a chunk, each in 3 parts over the whole bank
    assert len(calls) == 3 * len(inputs.scenes)
    assert sum(calls) == len(inputs.scenes) * len(templates)
    assert _rows(split) == _rows(whole)

    setting = reference.Setting.of(CONFIG)
    for scene, answer in zip(inputs.scenes, split):
        li, tr, size = reference.featuremap(scene, setting, "cpu")
        rows = reference.match(li, tr, size, templates, scene, setting, "cpu",
                               keep=TOP_K + compare.TIE_ROWS)
        assert len(answer) == TOP_K
        assert compare.scene_numbers(answer, rows, TOP_K) == {"score_gap": 0.0,
                                                              "rows_differ": 0}


def _tables_built_per_call(bank, mt):
    """The tables ``_genpairs_batch_dispatch`` built, and copied, on every
    call before the bank kept them."""
    counts = bank.counts_np.astype(np.int64)
    ord_t, k_t = tpipe.bank_line_table(bank.lengths_np, counts, mt)
    lens_m = np.where(np.arange(bank.lmax)[None, :] < counts[:, None],
                      bank.lengths_np, -np.inf)
    top_vals = np.take_along_axis(lens_m, ord_t.astype(np.int64), axis=1).astype(np.float32)
    rank_ok = np.arange(mt)[None, :] < k_t[:, None]
    return top_vals, ord_t, rank_ok


@pytest.mark.parametrize("mt", (1, 3, 4, 33))
def test_bank_tables_equal_the_per_call_tables(mt):
    bank = ot.prepare_templates(_inputs().whole_bank(), device="cpu")
    kept = tpipe._search_tables(bank, mt)
    for got, want in zip(kept, _tables_built_per_call(bank, mt)):
        assert got.device == bank.device
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert tpipe._search_tables(bank, mt) is kept
    np.testing.assert_array_equal(
        tpipe._template_lengths(bank),
        np.asarray(ot.geometry.get_template_lengths(bank.host), np.float32))


def test_bank_tables_made_once_per_bank_and_mt(monkeypatch):
    inputs = _inputs()
    templates = inputs.whole_bank()[:24]
    made, lengths = [], []
    real_table = tpipe.bank_line_table
    real_lengths = tpipe.geo.get_template_lengths
    monkeypatch.setattr(tpipe, "bank_line_table",
                        lambda *a: made.append(a[2]) or real_table(*a))
    monkeypatch.setattr(tpipe.geo, "get_template_lengths",
                        lambda t: lengths.append(len(t)) or real_lengths(t))
    bank = ot.prepare_templates(templates, device="cpu")
    first = [_rows(_match([s], bank)) for s in inputs.scenes]
    assert made == [4] and lengths == [24]
    assert [_rows(_match([s], bank)) for s in inputs.scenes] == first
    assert made == [4] and lengths == [24]
    _match(inputs.scenes[:1], bank, ot.DefaultSearch(3, M["max_scene_lines"]))
    assert made == [4, 3] and lengths == [24]
    _match(inputs.scenes[:1], ot.prepare_templates(templates, device="cpu"))
    assert made == [4, 3, 4] and lengths == [24, 24]
