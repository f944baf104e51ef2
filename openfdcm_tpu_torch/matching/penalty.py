"""Match re-scoring penalties (port of :mod:`openfdcm_tpu.matching.penalty`).

Reference ``src/penaltystrategies/{defaultpenalty,exponentialpenalty}.cpp``.
On the top-k paths the penalty is applied on the device before the top-k
(``match._search_device_batch_topk*``); ``apply`` is the host form used by
the host ranking path and :func:`penalize`.  Both take the power through
:func:`~openfdcm_tpu_torch.core.geometry.pow_f32`, so they give equal
scores.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.geometry import pow_f32


@dataclasses.dataclass(frozen=True)
class DefaultPenalty:
    """score' = score / max(len, 1e-6)  (``defaultpenalty.cpp:35-41``)."""

    def apply(self, score: np.ndarray, length: np.ndarray) -> np.ndarray:
        return (np.asarray(score, np.float32)
                / np.maximum(np.asarray(length, np.float32), np.float32(1e-6)))


@dataclasses.dataclass(frozen=True)
class ExponentialPenalty:
    """score' = score / max(len, 1e-6)^tau  (``exponentialpenalty.cpp:39-45``)."""
    tau: float = 1.5

    def get_tau(self) -> float:
        return self.tau

    def apply(self, score: np.ndarray, length: np.ndarray) -> np.ndarray:
        base = np.maximum(np.asarray(length, np.float32), np.float32(1e-6))
        return (np.asarray(score, np.float32)
                / pow_f32(torch.as_tensor(base), self.tau).numpy())


def penalize(penalty, matches, template_lengths):
    """Apply a penalty to a list of matches; raises ``IndexError`` if a
    match's template index exceeds the lengths vector, mirroring the
    reference's ``std::out_of_range`` (``defaultpenalty.cpp:42-57``)."""
    lengths = np.asarray(template_lengths, np.float32)
    if not matches:
        return []
    idx = np.fromiter((m.tmpl_idx for m in matches), np.int64, len(matches))
    if int(idx.max()) >= len(lengths):
        raise IndexError(
            "In penalize, the size of templatelengths is not consistent "
            "with match template indices")
    scores = np.fromiter((m.score for m in matches), np.float32, len(matches))
    new_scores = penalty.apply(scores, lengths[idx])
    return [type(m)(m.tmpl_idx, float(s), m.transform)
            for m, s in zip(matches, new_scores)]
