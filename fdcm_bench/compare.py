"""The comparison that decides ``correct``.

For each sampled scene the program's top-k answer (``Match`` objects:
template, penalized score, 2 x 3 transform) is held against the plain
reference's ranking of the same scene:

- ``score_gap``: the widest gap, over ranks, between the program's k-th
  score and the reference's, relative to the reference's (the two lists
  sorted ascending);
- ``rows_differ``: program rows with no reference row of the same template
  and transform (within ``TRANSFORM_TOL`` per entry) among the reference's
  top k and the rows tied with its k-th, plus reference top-k rows with no
  such program row.

A run compares every answer the window gave for each scene of its sample
and reports the largest ``score_gap`` and the largest ``rows_differ`` over
them; each limit lives in the configuration's file.
"""
from __future__ import annotations

import numpy as np

TRANSFORM_TOL = 1e-3
# reference rows ranked beyond the top k that still tie its k-th score
TIE_ROWS = 32


def same_row(template, transform, row) -> bool:
    return (template == row.template
            and float(np.max(np.abs(np.asarray(transform) - row.transform))) <= TRANSFORM_TOL)


def scene_numbers(answer, ref_rows, top_k) -> dict:
    """``answer``: the program's list of matches; ``ref_rows``: the
    reference's ranked rows, at least ``top_k`` plus ties where it has
    them."""
    head = ref_rows[:top_k]
    kth = head[-1].score if head else None
    pool = head + [r for r in ref_rows[top_k:] if kth is not None and r.score == kth]
    differ = sum(not any(same_row(m.tmpl_idx, m.transform, r) for r in pool)
                 for m in answer)
    differ += sum(not any(same_row(m.tmpl_idx, m.transform, r) for m in answer)
                  for r in head)
    got = np.sort(np.asarray([m.score for m in answer], np.float64))
    want = np.asarray([r.score for r in head], np.float64)
    n = min(len(got), len(want))
    gap = 0.0
    if n:
        gap = float(np.max(np.abs(got[:n] - want[:n]) / np.maximum(np.abs(want[:n]), 1e-6)))
    if np.isnan(gap):
        gap = float("inf")
    return {"score_gap": gap, "rows_differ": int(differ)}


def combine(per_answer: list) -> dict:
    if not per_answer:
        return {"score_gap": float("inf"), "rows_differ": 1}
    return {"score_gap": max(p["score_gap"] for p in per_answer),
            "rows_differ": max(p["rows_differ"] for p in per_answer)}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
