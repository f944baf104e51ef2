"""Match re-scoring penalties (port of :mod:`openfdcm_tpu.matching.penalty`).

Reference ``src/penaltystrategies/{defaultpenalty,exponentialpenalty}.cpp``.
On the slice's path the penalty is applied on the device before the top-k
(``match._search_device_batch_topk_genpairs``); ``apply`` is the host form.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DefaultPenalty:
    """score' = score / max(len, 1e-6)  (``defaultpenalty.cpp:35-41``)."""

    def apply(self, score: np.ndarray, length: np.ndarray) -> np.ndarray:
        return score / np.maximum(length, np.float32(1e-6))


@dataclasses.dataclass(frozen=True)
class ExponentialPenalty:
    """score' = score / max(len, 1e-6)^tau  (``exponentialpenalty.cpp:39-45``)."""
    tau: float = 1.5

    def get_tau(self) -> float:
        return self.tau

    def apply(self, score: np.ndarray, length: np.ndarray) -> np.ndarray:
        return score / np.power(np.maximum(length, np.float32(1e-6)),
                                np.float32(self.tau))
